"""RAFT's windowed bilinear correlation: kernel 5 of the port.

Port of ``ppvision_tpu/ops/corr.py`` (the reference's ``alt_cuda_corr``):
for each query pixel, the dot products of its fmap1 feature with a
bilinearly sampled (2r+1)^2 window of fmap2 around ``coords``, zero
outside the map, in true f32, (dy, dx) y-major.

- :func:`local_corr_ref`: the plain version, the four gathered corner
  dots of ``local_corr_xla``; the CPU path, the backward pass and the
  kernel's oracle on the card.
- :func:`local_corr`: on a CUDA tensor it launches ``csrc/corr.cu``
  (which replaces the Pallas kernel ``_corr_kernel``) or raises; on a
  CPU tensor it runs :func:`local_corr_ref`.  Its backward replays
  autograd through :func:`local_corr_ref`, as the JAX package's
  ``custom_vjp`` replays ``local_corr_xla``: there is no backward kernel.
  ``local_corr.launches`` counts kernel launches, ``local_corr.copies``
  the CUDA inputs that had to be made contiguous first.
- :func:`plan_corr`: the kernel's band of queries a block and its box
  ring, from the shape alone.
- :func:`alternate_corr_lookup`: the per-level composition of the
  reference's ``AlternateCorrBlock``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build
from .image import avg_pool_2x

__all__ = ["CorrPlan", "alternate_corr_lookup", "local_corr", "local_corr_ref", "plan_corr"]

_SIGS = {"local_corr": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]}


def local_corr_ref(
    fmap1: torch.Tensor, fmap2: torch.Tensor, coords: torch.Tensor, radius: int = 4
) -> torch.Tensor:
    """(B, H, W, (2r+1)^2) windowed correlation of fmap1 (B, H, W, C)
    against fmap2 (B, H2, W2, C) around ``coords`` (B, H, W, 2) = (x, y)."""
    b, h, w, c = fmap1.shape
    h2, w2 = fmap2.shape[1:3]
    r = radius
    k = 2 * r + 1
    off = torch.arange(-r, r + 1, dtype=torch.float32, device=coords.device)
    dy, dx = torch.meshgrid(off, off, indexing="ij")
    delta = torch.stack([dx, dy], -1).reshape(1, 1, 1, k * k, 2)
    pts = coords[:, :, :, None, :] + delta  # (B, H, W, K^2, 2)
    x, y = pts[..., 0], pts[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    bidx = torch.arange(b, device=fmap2.device).reshape(b, 1, 1, 1)

    def gather_dot(yy, xx):
        valid = (xx >= 0) & (xx <= w2 - 1) & (yy >= 0) & (yy <= h2 - 1)
        xi = xx.clamp(0, w2 - 1).long()
        yi = yy.clamp(0, h2 - 1).long()
        vals = fmap2[bidx, yi, xi]  # (B, H, W, K^2, C)
        return torch.einsum("bhwkc,bhwc->bhwk", vals, fmap1) * valid

    return (
        gather_dot(y0, x0) * (1 - wx) * (1 - wy)
        + gather_dot(y0, x0 + 1) * wx * (1 - wy)
        + gather_dot(y0 + 1, x0) * (1 - wx) * wy
        + gather_dot(y0 + 1, x0 + 1) * wx * wy
    )


# The kernel's design constants (csrc/corr.cu): threads a block, window
# points a lane at most; the card's SMs, the shared memory a block may
# take and an SM has.
_THREADS, _POINTS = 1024, 13
_SMS = 132
_SMEM_MAX, _SMEM_SM = 232448, 233472


class CorrPlan(NamedTuple):
    """qb queries a block (a band of consecutive queries of one image), cw
    channels a step, cap 16-byte units of fmap2 box a ring stage, and the
    block's threads and dynamic shared memory bytes as ``csrc/corr.cu``
    lays them out."""

    qb: int
    cw: int
    cap: int
    threads: int
    smem: int


@functools.lru_cache(maxsize=256)
def plan_corr(batch: int, hw: int, c: int, h2: int, w2: int, radius: int) -> CorrPlan:
    """The kernel's plan from the shape alone.  A query takes a quarter
    warp of lanes for each 104 of its (2r + 2)^2 window points, a block at
    most 1024 threads: the fewest waves of one block an SM that hold the
    queries, then the most blocks an image those waves hold, so that the
    bands are as short as the waves allow.  Then the widest channel step
    (16 .. 512, at most C) at which each of the ring's two stages holds
    the whole map; where none does, 16 channels and a box as large as
    shared memory allows."""
    k1 = 2 * radius + 2
    lanes = 8 * -(-k1 * k1 // (8 * _POINTS))
    least = -(-hw // (_THREADS // lanes))
    waves = -(-batch * least // _SMS)
    qb = -(-hw // min(hw, max(least, _SMS * waves // batch)))
    threads = -(-qb * lanes // 32) * 32
    header = (4 + 4 * qb + 3) // 4 * 4
    budget = min(_SMEM_MAX, _SMEM_SM // max(1, _THREADS // threads) - 1024) - 4 * header

    def units(cw: int) -> int:  # a stage: the band's points, a zero point, the whole map's rows
        return (qb + 1) * (cw // 4 + 1) + h2 * (w2 * (cw // 4 + 1) + 7)

    cw = 16
    while 2 * cw <= -(-c // 16) * 16 and 32 * units(2 * cw) <= budget:
        cw *= 2
    pu = cw // 4 + 1
    cap = min(units(cw), budget // 32) - (qb + 1) * pu
    floats = header + max(8 * ((qb + 1) * pu + cap), qb * (k1 * k1 + 1))
    return CorrPlan(qb, cw, cap, threads, 4 * floats)


def _launch(fmap1, fmap2, coords, radius: int, plan: CorrPlan | None = None) -> torch.Tensor:
    """The CUDA kernel, after checking what it takes; ``plan`` defaults
    to :func:`plan_corr`'s."""
    if fmap1.ndim != 4 or fmap2.ndim != 4 or coords.ndim != 4:
        raise ValueError("corr kernel takes NHWC fmap1, fmap2 and (B, H, W, 2) coords")
    b, h, w, c = fmap1.shape
    b2, h2, w2, c2 = fmap2.shape
    if (b2, c2) != (b, c) or tuple(coords.shape) != (b, h, w, 2):
        raise ValueError(
            f"corr kernel: fmap1 {tuple(fmap1.shape)}, fmap2 {tuple(fmap2.shape)} and coords "
            f"{tuple(coords.shape)} do not agree"
        )
    if c % 4 != 0 or not 0 < c <= 512 or not 0 <= radius <= 16:
        raise ValueError(f"corr kernel takes C % 4 = 0, C <= 512 and radius <= 16; got C={c}, r={radius}")
    if not (0 < b <= 65535 and h * w > 0 and h2 * w2 > 0):
        raise ValueError(f"corr kernel takes 1..65535 images and non-empty maps; got {b}, {h}x{w}, {h2}x{w2}")
    for t in (fmap1, fmap2, coords):
        if t.dtype != torch.float32 or t.device != fmap1.device:
            raise ValueError("corr kernel takes float32 tensors on one CUDA device")
    ins = []
    for t, align in ((fmap1, 16), (fmap2, 16), (coords, 8)):  # float4 and float2 reads
        if not t.is_contiguous():
            local_corr.copies += 1
            t = t.contiguous()
        if t.data_ptr() % align:
            raise ValueError(f"corr kernel takes fmap1 and fmap2 16-byte aligned, coords 8; got {t.data_ptr()}")
        ins.append(t)
    plan = plan or plan_corr(b, h * w, c, h2, w2, radius)
    k = 2 * radius + 1
    out = torch.empty((b, h, w, k * k), dtype=torch.float32, device=fmap1.device)
    lib = _build.load("corr", _SIGS)
    err = lib.local_corr(
        *(t.data_ptr() for t in ins), out.data_ptr(), b, h * w, h2, w2, c, radius, plan.qb, plan.cw, plan.cap,
        torch.cuda.current_stream(fmap1.device).cuda_stream,
    )
    _build.check(lib, err, "local_corr")
    local_corr.launches += 1
    return out


class _LocalCorr(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fmap1, fmap2, coords, radius):
        ctx.radius = radius
        ctx.save_for_backward(fmap1, fmap2, coords)
        if fmap1.device.type != "cuda":
            return local_corr_ref(fmap1, fmap2, coords, radius)
        return _launch(fmap1, fmap2, coords, radius)

    @staticmethod
    def backward(ctx, grad):
        ins = [
            t.detach().requires_grad_(need)
            for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:3])
        ]
        wanted = [t for t in ins if t.requires_grad]
        with torch.enable_grad():
            out = local_corr_ref(*ins, ctx.radius)
            grads = iter(torch.autograd.grad(out, wanted, grad))
        return tuple(next(grads) if t.requires_grad else None for t in ins) + (None,)


def local_corr(
    fmap1: torch.Tensor, fmap2: torch.Tensor, coords: torch.Tensor, radius: int = 4
) -> torch.Tensor:
    """Windowed correlation, (B, H, W, (2r+1)^2) f32.  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    return _LocalCorr.apply(fmap1, fmap2, coords, radius)


local_corr.launches = 0
local_corr.copies = 0


def alternate_corr_lookup(
    fmap1: torch.Tensor,
    fmap2: torch.Tensor,
    coords: torch.Tensor,
    num_levels: int = 4,
    radius: int = 4,
) -> torch.Tensor:
    """AlternateCorrBlock (reference corr.py:63-91): per level, pool fmap2
    2x and correlate the full-resolution fmap1 around coords / 2^l; concat
    the levels and scale by 1/sqrt(C).  One kernel launch per level."""
    c = fmap1.shape[-1]
    out = []
    f2 = fmap2
    for i in range(num_levels):
        out.append(local_corr(fmap1, f2, coords / (2**i), radius))
        if i + 1 < num_levels:
            f2 = avg_pool_2x(f2.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return torch.cat(out, dim=-1) / math.sqrt(c)
