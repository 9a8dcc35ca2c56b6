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
- :func:`alternate_corr_lookup`: the per-level composition of the
  reference's ``AlternateCorrBlock``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .image import avg_pool_2x

__all__ = ["alternate_corr_lookup", "local_corr", "local_corr_ref"]

_SIGS = {"local_corr": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]}


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


def _launch(fmap1, fmap2, coords, radius: int) -> torch.Tensor:
    """The CUDA kernel, after checking what it takes."""
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
    for t in (fmap1, fmap2, coords):
        if t.dtype != torch.float32 or t.device != fmap1.device:
            raise ValueError("corr kernel takes float32 tensors on one CUDA device")
    fmap1, fmap2, coords = fmap1.contiguous(), fmap2.contiguous(), coords.contiguous()
    k = 2 * radius + 1
    out = torch.empty((b, h, w, k * k), dtype=torch.float32, device=fmap1.device)
    lib = _build.load("corr", _SIGS)
    err = lib.local_corr(
        fmap1.data_ptr(), fmap2.data_ptr(), coords.data_ptr(), out.data_ptr(),
        b, h * w, h2, w2, c, radius, torch.cuda.current_stream(fmap1.device).cuda_stream,
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
