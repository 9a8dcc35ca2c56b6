"""Data parallelism over ``torch.distributed``: one process per GPU.

Port of ``ppvision_tpu/parallel/mesh.py``.  The JAX package runs SPMD
over a ``jax.sharding.Mesh``: the batch axis rides the ``data`` mesh
axis, parameters (and EMA and optimizer state) are replicated, and XLA
inserts the all-reduces that a reduction over the sharded batch needs.
Here each process owns one device and a contiguous block of every
global batch (process 0's rows first), the parameters are replicated
by broadcast from rank 0, and every reduction that couples samples is
an explicit collective:

- :func:`all_reduce_mean`, :func:`all_reduce_sum` and
  :func:`all_reduce_max` are ``torch.autograd.Function`` s, so the
  backward of a global statistic is itself a collective and N ranks
  compute what one process computes on the global batch;
- :func:`all_reduce_grads` averages a list of gradients over the ranks
  (the trainers take gradients with ``torch.autograd.grad``, so DDP's
  reducer hooks would never fire);
- :func:`mean_metrics` gives every rank the global metrics.

``with mesh:`` makes a :class:`Mesh` the one these functions use when
no mesh is passed.  Outside any mesh each of them is the identity, so
code that calls them runs as it did without a process group.  Inside a
mesh of one rank they still run: a sum over one rank and a division by
1 are exact, so the results are those of the no-mesh run bit for bit.

The active mesh is process-wide, not thread-local: a collective's
backward, and the forward that ``torch.utils.checkpoint`` recomputes,
run on autograd's threads and must find the same mesh.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..utils.device import resolve_device

__all__ = [
    "Mesh",
    "all_gather",
    "all_reduce_grads",
    "all_reduce_max",
    "all_reduce_mean",
    "all_reduce_sum",
    "batch_layout",
    "broadcast",
    "current_mesh",
    "initialize_multihost",
    "is_primary",
    "local_batch_size",
    "make_mesh",
    "mean_metrics",
    "process_slice",
    "replicate",
    "shard_batch",
]

DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)  # torch.distributed's default
_BUCKET_BYTES = 25 * 2**20  # DDP's default bucket
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(eq=False)
class Mesh:
    """A 1-D data-parallel mesh: the process group, this process's rank
    and the world size, and the local device.  ``traffic``
    counts the bytes each collective has moved through it (one rank's
    share: the tensor it hands the collective)."""

    group: Any
    rank: int
    world: int
    device: torch.device
    traffic: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    def __enter__(self) -> "Mesh":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)


_ACTIVE: list[Mesh] = []


def current_mesh() -> Mesh | None:
    """The innermost mesh entered with ``with mesh:``, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _local_device(device) -> torch.device:
    """``resolve_device``, with a bare ``cuda`` made ``cuda:LOCAL_RANK``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def _backend(dev: torch.device, backend: str | None) -> str:
    return backend or ("nccl" if dev.type == "cuda" else "gloo")


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device="cuda",
    backend: str | None = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> bool:
    """Join a multi-process job; returns whether a process group is now
    initialized.

    Explicit arguments make an init at ``coordinator_address``
    (``host:port`` means ``tcp://host:port``; a URL such as
    ``file:///path`` is taken as it is), and a failure raises
    ``RuntimeError``: a silent single-process fallback would train on
    1/N of the data and overwrite the checkpoints.  Without arguments
    it reads torchrun's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT``, or, when they are absent, stays single-process.
    The backend is NCCL for a CUDA ``device`` (``cuda:LOCAL_RANK``, made
    current) and gloo for the CPU, unless ``backend`` names one."""
    if dist.is_initialized():
        return True
    dev = _local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    explicit = not (coordinator_address is None and num_processes is None and process_id is None)
    if explicit:
        url = coordinator_address if "://" in str(coordinator_address) else f"tcp://{coordinator_address}"
        try:
            if coordinator_address is None or num_processes is None or process_id is None:
                raise ValueError("coordinator_address, num_processes and process_id are all needed")
            dist.init_process_group(_backend(dev, backend), init_method=url, world_size=num_processes,
                                    rank=process_id, timeout=timeout)
        except (ValueError, RuntimeError, OSError) as e:
            raise RuntimeError(
                f"multi-host init failed for coordinator {coordinator_address!r} "
                f"(processes={num_processes}, process_id={process_id}): {e}"
            ) from e
        return True
    if not all(k in os.environ for k in _TORCHRUN_ENV):
        return False
    try:
        dist.init_process_group(_backend(dev, backend), init_method="env://", timeout=timeout)
    except (ValueError, RuntimeError, OSError) as e:
        raise RuntimeError(f"multi-host init from torchrun's environment failed: {e}") from e
    return True


def make_mesh(device="cuda", timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """The mesh over every process of the default group, on this
    process's device (``cuda:LOCAL_RANK`` for ``cuda``).  Without a
    process group it starts one of a single process: NCCL for a CUDA
    device, gloo for the CPU.  Raises when CUDA is asked for and absent,
    as every entry point does."""
    dev = _local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(_backend(dev, None), store=dist.HashStore(), rank=0, world_size=1, timeout=timeout)
    if dev.type != "cuda" and dist.get_backend() == "nccl":
        raise ValueError("an NCCL process group cannot reduce CPU tensors; pass a CUDA device")
    return Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), dev)


def _mesh(mesh: Mesh | None) -> Mesh | None:
    return current_mesh() if mesh is None else mesh


def _rank_world(mesh: Mesh | None) -> tuple[int, int]:
    mesh = _mesh(mesh)
    if mesh is not None:
        return mesh.rank, mesh.world
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_primary(mesh: Mesh | None = None) -> bool:
    """True on rank 0: gate checkpoint writes and logging (the
    reference's vestigial ``gpu_rank == 0`` checks)."""
    return _rank_world(mesh)[0] == 0


def local_batch_size(global_batch: int, mesh: Mesh | None = None) -> int:
    """This process's share of a global batch."""
    p = _rank_world(mesh)[1]
    if global_batch % p != 0:
        raise ValueError(f"process count {p} must divide global batch {global_batch}")
    return global_batch // p


def process_slice(n_items: int, mesh: Mesh | None = None) -> slice:
    """The contiguous [start, stop) block of ``n_items`` global indices
    this process owns: blocks, not strides, so the blocks of all ranks in
    rank order are the global batch in its order."""
    k = local_batch_size(n_items, mesh)
    i = _rank_world(mesh)[0]
    return slice(i * k, (i + 1) * k)


def _leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_leaves(v, fn) for v in tree)
    return fn(tree)


def batch_layout(mesh: Mesh, batch: Any, local_batch: int | None = None) -> Any:
    """``"sharded"`` or ``"replicated"`` for each leaf of ``batch``, by the
    JAX ``shard_batch``'s rule for one device a process: a leaf is
    sharded when it has a leading axis, and, with ``local_batch``, when
    that axis is ``local_batch`` long (pass it whenever a replicated leaf
    may have a leading axis)."""
    return _leaves(batch, lambda x: _layout(x, local_batch))


def _layout(x, local_batch: int | None) -> str:
    shape = np.shape(x)
    sharded = len(shape) >= 1 and (local_batch is None or shape[0] == local_batch)
    return "sharded" if sharded else "replicated"


def shard_batch(mesh: Mesh, batch: Any, local_batch: int | None = None) -> Any:
    """Each process passes its local block of the global batch (its
    ``process_slice``); every leaf goes to the mesh's device as a tensor.
    A leaf :func:`batch_layout` calls replicated is one global copy: rank
    0's, broadcast to the others."""
    def place(x):
        t = torch.as_tensor(x).to(mesh.device)
        if mesh.world > 1 and _layout(x, local_batch) == "replicated":
            t = broadcast(t.contiguous(), mesh)
        return t

    return _leaves(batch, place)


def _count(mesh: Mesh, name: str, t: torch.Tensor) -> None:
    mesh.traffic[name] += t.numel() * t.element_size()


def broadcast(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rank 0's ``t`` into every rank's ``t`` (contiguous, on the mesh's
    device), in place; returns it."""
    with record_function("parallel.broadcast"):
        _count(mesh, "broadcast", t)
        dist.broadcast(t, src=dist.get_global_rank(mesh.group, 0), group=mesh.group)
    return t


def _tensors_of(obj, seen: set) -> list[torch.Tensor]:
    """The tensors of a module, an optimizer, a tensor, or a dict, list,
    tuple or dataclass of them, each once."""
    out = []

    def add(t):
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            out.append(t)

    if isinstance(obj, torch.nn.Module):
        for t in obj.state_dict().values():
            add(t)
    elif isinstance(obj, torch.optim.Optimizer):
        for group in obj.param_groups:
            for p in group["params"]:
                for _, t in sorted(obj.state.get(p, {}).items()):
                    add(t)
    elif isinstance(obj, torch.Tensor):
        add(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            out += _tensors_of(v, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            out += _tensors_of(v, seen)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            out += _tensors_of(getattr(obj, f.name), seen)
    return out


def replicate(mesh: Mesh | None, obj: Any) -> Any:
    """Make ``obj`` (a module, an optimizer, a tensor, or a dict, list,
    tuple or dataclass of them) rank 0's on every rank, in place, by
    broadcast; returns it.  Each tensor takes rank 0's values through
    ``copy_``, which bumps its version, so caches keyed on a weight's
    version (the packed conv3x3 weights) see the change."""
    if mesh is None:
        return obj
    with torch.no_grad():
        for t in _tensors_of(obj, set()):
            t.copy_(broadcast(t.to(mesh.device, copy=True, memory_format=torch.contiguous_format), mesh))
    return obj


def _reduce(t: torch.Tensor, op, mesh: Mesh, name: str) -> torch.Tensor:
    _count(mesh, name, t)
    dist.all_reduce(t, op=op, group=mesh.group)
    return t


def _dense(t: torch.Tensor) -> torch.Tensor:
    return t.clone(memory_format=torch.contiguous_format)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        with record_function("parallel.all_reduce_sum"):
            return _reduce(_dense(x), dist.ReduceOp.SUM, mesh, "all_reduce_sum")

    @staticmethod
    def backward(ctx, g):
        with record_function("parallel.all_reduce_sum"):
            return _reduce(_dense(g), dist.ReduceOp.SUM, ctx.mesh, "all_reduce_sum"), None


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        with record_function("parallel.all_reduce_mean"):
            return _reduce(_dense(x), dist.ReduceOp.SUM, mesh, "all_reduce_mean").div_(mesh.world)

    @staticmethod
    def backward(ctx, g):
        with record_function("parallel.all_reduce_mean"):
            return _reduce(_dense(g), dist.ReduceOp.SUM, ctx.mesh, "all_reduce_mean").div_(ctx.mesh.world), None


class _AllReduceMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        with record_function("parallel.all_reduce_max"):
            y = _reduce(_dense(x), dist.ReduceOp.MAX, mesh, "all_reduce_max")
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        # The incoming gradient summed over the ranks goes to the ranks
        # holding the max, split evenly among them (torch.amax's rule
        # over a stack of the ranks' tensors); one collective carries
        # both the gradient and the count of holders.
        x, y = ctx.saved_tensors
        hold = (x == y).to(g.dtype)
        with record_function("parallel.all_reduce_max"):
            both = _reduce(torch.stack([g, hold]), dist.ReduceOp.SUM, ctx.mesh, "all_reduce_max")
        return both[0] * hold / both[1], None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """The elementwise sum of ``x`` over the ranks; its backward sums the
    incoming gradient over the ranks.  The identity outside a mesh."""
    mesh = _mesh(mesh)
    return x if mesh is None else _AllReduceSum.apply(x, mesh)


def all_reduce_mean(x: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """The elementwise mean of ``x`` over the ranks (sum / W); its backward
    is the same mean of the incoming gradient.  The identity outside a mesh."""
    mesh = _mesh(mesh)
    return x if mesh is None else _AllReduceMean.apply(x, mesh)


def all_reduce_max(x: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks; its backward gives the
    gradient summed over the ranks to the rank(s) holding the max, split
    evenly between ties.  The identity outside a mesh."""
    mesh = _mesh(mesh)
    return x if mesh is None else _AllReduceMax.apply(x, mesh)


@torch.no_grad()
def all_reduce_grads(grads: list[torch.Tensor], mesh: Mesh | None = None) -> list[torch.Tensor]:
    """The mean over the ranks of each gradient, reduced in flat buckets
    of up to 25 MiB of one dtype; returns views of the buckets in the
    gradients' shapes.  The list as it is outside a mesh."""
    mesh = _mesh(mesh)
    grads = list(grads)
    if mesh is None:
        return grads
    out: list[torch.Tensor | None] = [None] * len(grads)
    buckets: dict[torch.dtype, list[list[int]]] = {}
    fill: dict[torch.dtype, int] = {}
    for i, g in enumerate(grads):
        runs = buckets.setdefault(g.dtype, [[]])
        size = g.numel() * g.element_size()
        if runs[-1] and fill[g.dtype] + size > _BUCKET_BYTES:
            runs.append([])
            fill[g.dtype] = 0
        runs[-1].append(i)
        fill[g.dtype] = fill.get(g.dtype, 0) + size
    with record_function("parallel.all_reduce_grads"):
        for runs in buckets.values():
            for idx in runs:
                flat = torch.cat([grads[i].reshape(-1).to(mesh.device) for i in idx])
                _reduce(flat, dist.ReduceOp.SUM, mesh, "all_reduce_grads").div_(mesh.world)
                for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
                    out[i] = part.view(grads[i].shape).to(grads[i].device)
    return out


@torch.no_grad()
def mean_metrics(metrics: dict[str, torch.Tensor], mesh: Mesh | None = None) -> dict[str, torch.Tensor]:
    """Each 0-d metric's mean over the ranks, in f64 and back in its own
    dtype and device, so that rank 0 logs the global metrics.  The dict
    as it is outside a mesh."""
    mesh = _mesh(mesh)
    if mesh is None:
        return metrics
    keys = list(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k]).detach().to(mesh.device, torch.float64) for k in keys])
    with record_function("parallel.mean_metrics"):
        _reduce(vals, dist.ReduceOp.SUM, mesh, "mean_metrics").div_(mesh.world)
    out = {}
    for k, v in zip(keys, vals):
        ref = torch.as_tensor(metrics[k])
        out[k] = v.to(ref.device, ref.dtype)
    return out


@torch.no_grad()
def all_gather(x: torch.Tensor, dim: int = 0, mesh: Mesh | None = None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (every
    rank gets it).  The tensor as it is outside a mesh."""
    mesh = _mesh(mesh)
    if mesh is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    with record_function("parallel.all_gather"):
        _count(mesh, "all_gather", x)
        dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, dim=dim)
