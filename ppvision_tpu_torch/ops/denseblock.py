"""One FAN DenseConvBlock (in = out features) in one launch: kernel 2.

``fused_dense_block`` computes three stages of FrozenBN scale/shift
(compute dtype) -> ReLU -> SAME 3x3 conv, then ``concat([o1, o2, o3]) +
x``, on NHWC tensors.  On CUDA it launches ``csrc/denseblock.cu``
(8x8 output tiles with a recomputed 3-pixel halo, ``mma.sync`` bf16
convs; it replaces the Pallas kernel
``ppvision_tpu/ops/denseblock.py::_kernel``);
on the CPU it runs :func:`dense_block_ref`, the plain op chain that
``models/fan.py`` runs unfused.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["fused_dense_block", "dense_block_ref", "dense_block_supported"]

_SIGS = {"denseblock": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]}

BnPair = tuple[torch.Tensor, torch.Tensor]


def _bn_relu(h: torch.Tensor, mul: torch.Tensor, add: torch.Tensor) -> torch.Tensor:
    """Folded FrozenBatchNorm in the compute dtype, then ReLU."""
    return torch.relu(h * mul.to(h.dtype) + add.to(h.dtype))


def _conv3x3_nhwc(h: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    y = F.conv2d(h.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1).to(h.dtype), padding=1)
    return y.permute(0, 2, 3, 1)


def dense_block_ref(x, k1, k2, k3, bn1: BnPair, bn2: BnPair, bn3: BnPair) -> torch.Tensor:
    """Plain version: NHWC ``x``, HWIO kernels, (mul, add) f32 pairs."""
    o1 = _conv3x3_nhwc(_bn_relu(x, *bn1), k1)
    o2 = _conv3x3_nhwc(_bn_relu(o1, *bn2), k2)
    o3 = _conv3x3_nhwc(_bn_relu(o2, *bn3), k3)
    return torch.cat([o1, o2, o3], dim=-1) + x


def dense_block_supported(x: torch.Tensor) -> bool:
    """What the kernel takes: bf16 NHWC with F in {128, 256}."""
    return x.ndim == 4 and x.dtype == torch.bfloat16 and x.shape[-1] in (128, 256)


def _pack_bn(bns, f: int, device) -> torch.Tensor:
    """The three (mul, add) pairs as one zero-padded (6, F) f32 tensor."""
    packed = torch.zeros((6, f), dtype=torch.float32, device=device)
    for i, (mul, add) in enumerate(bns):
        packed[2 * i, : mul.shape[0]] = mul
        packed[2 * i + 1, : add.shape[0]] = add
    return packed


def fused_dense_block(x, k1, k2, k3, bn1: BnPair, bn2: BnPair, bn3: BnPair) -> torch.Tensor:
    """Whole DenseConvBlock on an NHWC batch.  ``k1..k3`` are HWIO
    kernels (3,3,F,F/2), (3,3,F/2,F/4), (3,3,F/4,F/4) in the compute
    dtype.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    if x.device.type != "cuda":
        return dense_block_ref(x, k1, k2, k3, bn1, bn2, bn3)
    if not dense_block_supported(x):
        raise ValueError(
            f"denseblock kernel takes bf16 NHWC input with 128 or 256 channels, "
            f"got {x.dtype} {tuple(x.shape)}"
        )
    b, h, w, f = x.shape
    want = ((3, 3, f, f // 2), (3, 3, f // 2, f // 4), (3, 3, f // 4, f // 4))
    ks = []
    for k, shape in zip((k1, k2, k3), want):
        if tuple(k.shape) != shape or k.device != x.device:
            raise ValueError(f"denseblock kernel weight must be {shape} on {x.device}")
        ks.append(k.to(torch.bfloat16).contiguous())
    x = x.contiguous()
    bn = _pack_bn((bn1, bn2, bn3), f, x.device)
    out = torch.empty_like(x)
    lib = _build.load("denseblock", _SIGS)
    err = lib.denseblock(
        x.data_ptr(), ks[0].data_ptr(), ks[1].data_ptr(), ks[2].data_ptr(), bn.data_ptr(),
        out.data_ptr(), b, h, w, f, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "denseblock")
    fused_dense_block.launches += 1
    return out


fused_dense_block.launches = 0
