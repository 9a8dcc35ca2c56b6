"""The port's data parallelism (parallel/mesh.py) against the JAX package.

- ``initialize_multihost`` raises on a failed explicit init, is a no-op
  with no arguments and no environment, and starts a group from
  torchrun's variables; ``make_mesh`` starts a one-process group when
  there is none.
- ``process_slice``, ``local_batch_size`` and ``shard_batch``'s
  sharded-or-replicated rule give what ``ppvision_tpu.parallel.mesh``
  gives on the same shapes.
- The collectives' gradients on two gloo ranks equal one process's
  autograd of the global loss at f64, ties of the max included (1e-12).
- Two ranks against the JAX package on one global batch: the caption
  lens's sensor with one bright outlier image (the
  ``tests/test_lens_sharding.py`` input; 1e-4 of the max, the f32 bound
  of ``tests/test_torch_lens.py``), and ``DeIdServer(mesh=)`` at the
  ``tests/test_serve.py`` sharded config against ``deid_multi_style``
  (1e-3, ``tests/test_torch_deid.py``'s f32 bound); the server's
  batch-size ``ValueError``.

The ranks are processes of their own (``tests/torch_ranks.py``), two
per test, one torch thread each.
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ppvision_tpu.parallel import mesh as jmesh
from ppvision_tpu_torch.parallel import mesh as pm

from . import torch_ranks
from .torch_parity import TINY, jax_bundle, torch_bundle, two_threads  # noqa: F401

LENS_TOL = 1e-4  # of the max, tests/test_torch_lens.py's f32 bound
DEID_TOL = 1e-3  # tests/test_torch_deid.py's f32 bound


@pytest.fixture
def no_group():
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_initialize_multihost_explicit_failure_raises(monkeypatch, no_group):
    """A typo'd coordinator must not fall back to one process."""

    def boom(*a, **kw):
        raise RuntimeError("connection refused")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="multi-host init failed.*bad-host:1234"):
        pm.initialize_multihost("bad-host:1234", 2, 0, device="cpu")
    with pytest.raises(RuntimeError, match="multi-host init failed.*all needed"):
        pm.initialize_multihost("bad-host:1234", device="cpu")


def test_initialize_multihost_without_arguments_or_environment_is_a_noop(monkeypatch, no_group):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert pm.initialize_multihost(device="cpu") is False
    assert not dist.is_initialized()
    assert pm.is_primary() and pm.process_slice(8) == slice(0, 8)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_torchrun_environment_and_a_one_process_mesh(monkeypatch, no_group):
    """torchrun's variables start a group (here of one process); without a
    group ``make_mesh`` starts one.  A world-1 mesh's collectives give
    their inputs back bit for bit, and outside a mesh they are the
    identity."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    assert pm.initialize_multihost(device="cpu") is True
    mesh = pm.make_mesh("cpu")
    assert (mesh.rank, mesh.world, mesh.device.type) == (0, 1, "cpu")
    dist.destroy_process_group()
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k)
    mesh = pm.make_mesh("cpu")
    assert dist.is_initialized() and mesh.world == 1
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 5)))
    grads = [x[0].clone(), x[1:].clone()]
    assert pm.all_reduce_mean(x) is x and pm.all_reduce_grads(grads)[0] is grads[0]
    with mesh:
        for fn in (pm.all_reduce_mean, pm.all_reduce_sum, pm.all_reduce_max):
            assert torch.equal(fn(x), x)
        assert all(torch.equal(a, b) for a, b in zip(pm.all_reduce_grads(grads), grads))
        m = pm.mean_metrics({"a": torch.tensor(0.1, dtype=torch.float32),
                             "b": torch.tensor(1 / 3, dtype=torch.float64)})
        assert m["a"].dtype == torch.float32 and float(m["a"]) == float(torch.tensor(0.1)) and float(m["b"]) == 1 / 3
    assert mesh.traffic["all_reduce_grads"] == 15 * 8 and mesh.traffic["mean_metrics"] == 2 * 8


@pytest.mark.parametrize("p", [1, 2, 4])
def test_process_slice_and_local_batch_size_match_jax(monkeypatch, p):
    for i in range(p):
        monkeypatch.setattr(jax, "process_count", lambda: p)
        monkeypatch.setattr(jax, "process_index", lambda i=i: i)
        mesh = pm.Mesh(None, i, p, torch.device("cpu"))
        for n in (4, 8, 12):
            assert pm.local_batch_size(n, mesh) == jmesh.local_batch_size(n)
            assert pm.process_slice(n, mesh) == jmesh.process_slice(n)
        if p > 1:
            with pytest.raises(ValueError):
                jmesh.local_batch_size(p + 1)
            with pytest.raises(ValueError):
                pm.local_batch_size(p + 1, mesh)


def _batch(local: int) -> dict:
    return dict(x=np.zeros((local, 4, 4, 3), np.float32), y=np.zeros((local,), np.int32),
                step=np.float32(3), schedule=np.zeros((2,), np.float32), nested=[np.zeros((local, 2))])


@pytest.mark.parametrize("local_batch", [None, 4])
def test_shard_batch_layout_matches_jax(monkeypatch, local_batch):
    """One device a process: at one process the JAX single-process rule on
    a one-device mesh, at two the multi-host rule (its process count
    patched to 2 and the global assembly recorded, not made)."""
    batch = _batch(4)

    def spec(sharding):
        return "sharded" if tuple(sharding.spec) == ("data",) else "replicated"

    one = jax.tree_util.tree_map(lambda a: spec(a.sharding),
                                 jmesh.shard_batch(jmesh.make_mesh(n_devices=1), batch, local_batch=local_batch))
    assert pm.batch_layout(pm.Mesh(None, 0, 1, torch.device("cpu")), batch, local_batch) == one

    seen = []

    def record(sharding, x, global_shape):
        seen.append(spec(sharding))
        return x

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "make_array_from_process_local_data", record)
    jmesh.shard_batch(jmesh.make_mesh(n_devices=2), batch, local_batch=local_batch)
    two = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(batch), seen)
    assert pm.batch_layout(pm.Mesh(None, 1, 2, torch.device("cpu")), batch, local_batch) == two
    if local_batch:
        assert two["schedule"] == "replicated" and two["x"] == "sharded"
    # The port places every leaf as a tensor on the mesh's device.
    placed = pm.shard_batch(pm.Mesh(None, 0, 1, torch.device("cpu")), batch, local_batch=local_batch)
    assert isinstance(placed["nested"][0], torch.Tensor) and placed["x"].shape == (4, 4, 4, 3)


def test_collective_gradients_match_one_process_autograd_at_f64(tmp_path):
    """Rank r's x = a[r] * theta; loss_r = sum(w[r] * sin(c(x))).  The
    ranks' mean gradient of theta equals one process's gradient of the
    global loss mean_r(loss_r), with c the mean, sum or max over the
    stacked x; the max has ties across the ranks at two entries."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 6))
    a[1, 2], a[1, 4] = a[0, 2], a[0, 4]  # ties of the max
    w = rng.standard_normal((2, 6))
    ranks = torch_ranks.launch("collectives", 2, tmp_path, a=a, w=w)
    ops = {"all_reduce_mean": lambda x: x.mean(0), "all_reduce_sum": lambda x: x.sum(0),
           "all_reduce_max": lambda x: x.amax(0)}
    for name, op in ops.items():
        theta = torch.linspace(0.5, 1.5, 6, dtype=torch.float64, requires_grad=True)
        y = op(torch.from_numpy(a) * theta)
        loss = (torch.from_numpy(w) * torch.sin(y)).sum(1).mean()
        (want,) = torch.autograd.grad(loss, theta)
        for r in ranks:
            torch.testing.assert_close(r[name]["value"], y.detach(), rtol=1e-15, atol=0)
            torch.testing.assert_close(r[name]["grad"], want, rtol=1e-12, atol=1e-15)


def test_lens_sensor_on_two_ranks_matches_jax_on_the_batch(tmp_path, monkeypatch):
    from ppvision_tpu.optics import lens as jl

    monkeypatch.setenv("PPVISION_CACHE", str(tmp_path))
    spec = dict(wave_res=64, patch_size=32, zernike_terms=16, height_tolerance=0.0)
    img = np.random.default_rng(0).uniform(size=(8, 32, 32, 3)).astype(np.float32)
    img[3] *= 5.0  # one bright outlier: a per-rank max would normalize rank 1 differently
    js = jl.LensSpec(**spec)
    want = np.asarray(jax.jit(lambda x: jl.lens_apply(jl.init_lens_params(js), jl.make_lens_constants(js), js,
                                                        x).sensor)(jnp.asarray(img)))
    got = np.concatenate(torch_ranks.launch("lens", 2, tmp_path, images=img, spec=spec))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LENS_TOL * np.abs(want).max()
    assert got[4:].max() < 0.5 and got.max() == pytest.approx(1.0, rel=1e-6)


def test_sharded_server_matches_jax_deid(tmp_path):
    """Two ranks serve 9 images in batches of 8 (the tail padded by
    repetition), then 3 under a flush deadline; rank 0's outputs against
    JAX ``deid_multi_style`` on the same padded batches, whose skip mean
    is the global batch's."""
    from ppvision_tpu.deid import deid_multi_style

    jb = jax_bundle("float32")
    tb = torch_bundle(jb, "float32")
    weights = {k: getattr(tb, k).state_dict() for k in ("camera", "fan", "generator", "mapping_network",
                                                        "style_encoder")}
    rng = np.random.default_rng(1)
    xr = rng.random((2, 64, 64, 3)).astype(np.float32)
    yr = np.zeros((2,), np.int64)
    imgs = [rng.random((64, 64, 3)).astype(np.float32) for _ in range(9)]
    running = torch_ranks.Ranks("server", 2, tmp_path, model=dict(TINY, compute_dtype="float32"), weights=weights,
                                x_ref=xr, y_ref=yr, images=imgs, batch_size=8, depth=2)
    fn = jax.jit(lambda xs: deid_multi_style(jb, jb.params, xs, jnp.asarray(xr), jnp.asarray(yr, jnp.int32)))
    want = np.concatenate([np.asarray(fn(np.stack(imgs[:8]))), np.asarray(fn(np.stack([imgs[8]] * 8)))[:, :1]],
                          axis=1)
    tail = np.asarray(fn(np.stack(imgs[:3] + [imgs[2]] * 5)))[:, :3]
    ranks = running.results()
    lead, follow = ranks
    assert len(lead["first"]) == 9 and len(lead["deadline"]) == 3
    assert follow["first"] == [] and follow["deadline"] == []
    for got, w in ((lead["first"], want), (lead["deadline"], tail)):
        got = np.stack(got, axis=1)
        assert got.shape == w.shape
        assert np.abs(got - w).max() <= DEID_TOL, np.abs(got - w).max()
    assert lead["refused"] and follow["refused"]
    for r in ranks:
        assert r["stats"]["completed"] == 12 and r["stats"]["batches_dispatched"] == 3
