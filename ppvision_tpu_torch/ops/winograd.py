"""Stride-1 SAME 3x3 convolution on NHWC bf16: kernel 4 of the port.

``conv3x3(x, w)`` takes an NHWC batch and a (3, 3, C, K) HWIO kernel
and returns the bias-free conv, f32-accumulated and rounded to the
input dtype once.  On CUDA it launches ``csrc/winograd.cu`` (an
implicit-GEMM direct conv on ``mma.sync`` bf16 tiles; it replaces the
Winograd F(2,3) Pallas kernel ``ppvision_tpu/ops/winograd.py::_kernel``, whose
1-D form a Mosaic limit forced); on the CPU it runs
:func:`conv3x3_ref`, the plain ``F.conv2d``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["conv3x3", "conv3x3_ref", "conv3x3_supported"]

_SIGS = {"conv3x3": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]}


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
    """Bias-free SAME 3x3 conv, NHWC x HWIO -> NHWC.  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    if x.device.type != "cuda":
        return conv3x3_ref(x, w)
    b, h, wd, c = x.shape
    k = w.shape[-1]
    if not conv3x3_supported(x, k) or tuple(w.shape[:3]) != (3, 3, c):
        raise ValueError(
            f"conv3x3 kernel takes bf16 NHWC input and a (3, 3, C, K) kernel with "
            f"C, K % 16 = 0; got {x.dtype} {tuple(x.shape)} and {tuple(w.shape)}"
        )
    if w.dtype != torch.bfloat16 or w.device != x.device:
        raise ValueError("conv3x3 kernel weight must be bf16 on the input's device")
    x = x.contiguous()
    w = w.contiguous()
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
