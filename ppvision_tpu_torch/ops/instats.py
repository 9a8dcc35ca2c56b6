"""Per-(sample, channel) E[x] and E[x^2] over H, W: kernel 3 (Triton).

``instance_moments(x)`` returns the f32 (B, C) mean and mean of squares
of an NHWC tensor, each sum divided by n = H*W once, as ``jnp.mean``
does.  On CUDA it launches a Triton kernel that replaces the Pallas
kernel ``ppvision_tpu/ops/instats.py::_kernel``; on the CPU it runs
:func:`_moments_ref`.

What bounds it on an H100: it reads each input byte once and writes
8 bytes per (sample, channel), a pure streaming reduction with no
tensor-core work, so HBM bandwidth sets its floor.  One program owns
16 channels of one sample (32 contiguous bytes of bf16 per pixel, one
full DRAM sector) and walks H*W in blocks of 256 pixels with f32
accumulators; the reduction never crosses programs, so the result is
deterministic.

``triton`` is imported, and the kernel compiled, at the first launch:
the module imports without it.
"""

from __future__ import annotations

import os

import torch

from . import _build

__all__ = ["instance_moments", "_moments_ref"]

# Bound to ``triton.language`` at the first launch (see _triton_kernel);
# the annotations below stay strings until Triton reads them.
tl = None
_KERNEL = None
_BLOCK_HW = 256
_BLOCK_C = 16


def _moments_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: f32 mean and mean of squares over (H, W)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    return xf.mean(dim=(1, 2)), (xf * xf).mean(dim=(1, 2))


def _moments_kernel(x_ptr, m_ptr, m2_ptr, HW, C, n, BLOCK_HW: tl.constexpr, BLOCK_C: tl.constexpr):
    b = tl.program_id(0)
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    base = x_ptr + b.to(tl.int64) * HW * C
    acc = tl.zeros((BLOCK_HW, BLOCK_C), dtype=tl.float32)
    acc2 = tl.zeros((BLOCK_HW, BLOCK_C), dtype=tl.float32)
    for start in range(0, HW, BLOCK_HW):
        rows = start + tl.arange(0, BLOCK_HW)
        mask = (rows < HW)[:, None] & cmask[None, :]
        v = tl.load(base + rows[:, None] * C + cols[None, :], mask=mask, other=0.0)
        v = v.to(tl.float32)
        acc += v
        acc2 += v * v
    s = tl.sum(acc, axis=0)
    s2 = tl.sum(acc2, axis=0)
    # IEEE division, as jnp.mean divides its f32 sum by n.
    tl.store(m_ptr + b * C + cols, tl.fdiv(s, n, ieee_rounding=True), mask=cmask)
    tl.store(m2_ptr + b * C + cols, tl.fdiv(s2, n, ieee_rounding=True), mask=cmask)


def _triton_kernel():
    global tl, _KERNEL
    if _KERNEL is None:
        # Triton's compile cache goes beside the CUDA builds, inside the
        # checkout, unless the caller chose a place.
        os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(_build.BUILD_DIR, "triton"))
        import triton
        import triton.language

        tl = triton.language
        _KERNEL = triton.jit(_moments_kernel)
    return _KERNEL


def instance_moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, mean of squares) over the (H, W) axes of an NHWC tensor,
    f32, shape (B, C) each.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if x.device.type != "cuda":
        return _moments_ref(x)
    if x.ndim != 4 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"instats kernel takes bf16/f32 NHWC input, got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    b, h, w, c = x.shape
    m = torch.empty((b, c), dtype=torch.float32, device=x.device)
    m2 = torch.empty_like(m)
    kernel = _triton_kernel()
    grid = (b, (c + _BLOCK_C - 1) // _BLOCK_C)
    kernel[grid](x, m, m2, h * w, c, float(h * w), BLOCK_HW=_BLOCK_HW, BLOCK_C=_BLOCK_C,
                 num_warps=4)
    instance_moments.launches += 1
    return m, m2


instance_moments.launches = 0
