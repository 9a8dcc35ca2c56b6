"""Stride-1 SAME 3x3 convolution on NHWC bf16: kernel 4 of the port.

``conv3x3(x, w)`` takes an NHWC batch and a (3, 3, C, K) HWIO kernel, or
that kernel packed once by :func:`pack_conv3x3_weight`, and returns the
bias-free conv, f32-accumulated and rounded to the input dtype once.  On
CUDA it launches ``csrc/winograd.cu``, which replaces the Winograd F(2,3)
Pallas kernel ``ppvision_tpu/ops/winograd.py::_kernel`` (whose 1-D form a
Mosaic limit forced) with a direct implicit GEMM on ``wgmma``: the
tensor cores bound these convs on an H100 (shared memory feeds them at
the kernel's tiles).  A block computes 64, 128 or 256 valid output
pixels (a box of rows, columns and, at 8^2 and 4^2, whole images) for
128 output channels (64 where K is not a multiple of 128), in stages of
one tap x 64 input channels, both operands in shared memory in
``wgmma``'s 128-byte-swizzled layout; the packed weights are that exact
image, so a stage's weight tile is one contiguous run, loaded by one
bulk copy.  The source's head
note gives the tile rule and the bytes it reads from L2.  On the CPU it
runs :func:`conv3x3_ref`, the plain ``F.conv2d``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = [
    "conv3x3",
    "conv3x3_ref",
    "conv3x3_supported",
    "pack_conv3x3_weight",
    "unpack_conv3x3_weight",
]

_SIGS = {"conv3x3": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]}


def pack_conv3x3_weight(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, K) HWIO -> (9, ceil(C / 64), K, 8, 8): for each tap and
    64 input channels, K rows of 128 bytes (one an output channel) in
    ``wgmma``'s 128-byte-swizzled K-major layout: row n keeps channel
    group g (8 channels) in its 16-byte chunk g ^ (n % 8), so that
    ``packed[t, s, n, g ^ (n % 8), e] = w[t // 3, t % 3, 64 s + 8 g + e, n]``
    (zeros past C)."""
    kh, kw, c, k = w.shape
    if (kh, kw) != (3, 3) or c % 16:
        raise ValueError(f"pack_conv3x3_weight takes (3, 3, C, K) with C % 16 = 0; got {tuple(w.shape)}")
    s = -(-c // 64)
    w = F.pad(w.reshape(9, c, k), (0, 0, 0, 64 * s - c))
    w = w.reshape(9, s, 8, 8, k).permute(0, 1, 4, 2, 3)  # (tap, slice, n, group, e)
    return w.gather(3, _swizzle_index(w)).contiguous()


def unpack_conv3x3_weight(p: torch.Tensor, c: int) -> torch.Tensor:
    """The HWIO kernel of ``c`` input channels back from
    :func:`pack_conv3x3_weight`'s copy (the swizzle is its own inverse)."""
    k = p.shape[2]
    w = p.gather(3, _swizzle_index(p)).permute(0, 1, 3, 4, 2).reshape(9, -1, k)
    return w[:, :c].reshape(3, 3, c, k)


def _swizzle_index(t: torch.Tensor) -> torch.Tensor:
    """Index of chunk g ^ (n % 8) along dim 3 of a (9, S, K, 8, 8) view."""
    n = torch.arange(t.shape[2], device=t.device)[:, None]
    g = torch.arange(8, device=t.device)[None, :]
    return (g ^ (n % 8))[None, None, :, :, None].expand(t.shape)


def conv3x3_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: SAME 3x3 conv of NHWC ``x`` with HWIO ``w``."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).to(x.dtype), padding=1)
    return y.permute(0, 2, 3, 1)


def conv3x3_supported(x: torch.Tensor, features: int) -> bool:
    """What the kernel takes: bf16 NHWC, channels and features % 16 = 0."""
    return (
        x.ndim == 4 and x.dtype == torch.bfloat16 and x.shape[-1] % 16 == 0 and features % 16 == 0
    )


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Bias-free SAME 3x3 conv, NHWC x (HWIO or packed) -> NHWC.  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise.  An HWIO ``w`` is packed on every call: a caller that reuses
    its weights packs them once (``models/stargan.py::Conv``)."""
    packed = w.ndim == 5
    b, h, wd, c = x.shape
    if x.device.type != "cuda":
        return conv3x3_ref(x, unpack_conv3x3_weight(w, c) if packed else w)
    k = w.shape[2] if packed else w.shape[-1]
    want = (9, -(-c // 64), k, 8, 8) if packed else (3, 3, c, k)
    if not conv3x3_supported(x, k) or tuple(w.shape) != want:
        raise ValueError(
            f"conv3x3 kernel takes bf16 NHWC input and a (3, 3, C, K) kernel (or its packed "
            f"copy) with C, K % 16 = 0; got {x.dtype} {tuple(x.shape)} and {tuple(w.shape)}"
        )
    if w.dtype != torch.bfloat16 or w.device != x.device:
        raise ValueError("conv3x3 kernel weight must be bf16 on the input's device")
    x = x.contiguous()
    w = w.contiguous() if packed else pack_conv3x3_weight(w)
    out = torch.empty((b, h, wd, k), dtype=x.dtype, device=x.device)
    lib = _build.load("winograd", _SIGS)
    err = lib.conv3x3(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd, c, k,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "conv3x3")
    conv3x3.launches += 1
    return out


conv3x3.launches = 0
