"""One FAN DenseConvBlock (in = out features): kernel 2.

``fused_dense_block`` computes three stages of FrozenBN scale/shift
(compute dtype) -> ReLU -> SAME 3x3 conv, then ``concat([o1, o2, o3]) +
x``, on NHWC tensors.  On CUDA it runs ``csrc/denseblock.cu``, which
replaces the Pallas kernel ``ppvision_tpu/ops/denseblock.py::_kernel``;
on the CPU it runs :func:`dense_block_ref`, the plain op chain that
``models/fan.py`` runs unfused.

On an H100 the tensor cores bound the block at 64^2 and 32^2 (~790
flops a byte at F = 256); at 4^2-8^2 its passes are a few blocks each,
and the weights, which every block restages from L2, and launch latency
bind.  The TPU kernel chained the three convs over a whole image in
VMEM; shared memory cannot hold one, and a fused tile would recompute a
halo through the chain, so the kernel runs four passes on the caller's
stream, one C call: ``bn_relu1(x)`` into a scratch, then the three
convs over valid pixels only on conv3x3's ``wgmma`` mainloop, each
epilogue writing ``o_k + x`` into its channels of the output and
``bn_relu_{k+1}(o_k)`` into the next pass's input.  The intermediates
stay in L2.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .winograd import pack_conv3x3_weight, unpack_conv3x3_weight

__all__ = ["fused_dense_block", "dense_block_ref", "dense_block_supported", "pack_dense_bn"]

_SIGS = {"denseblock": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]}

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


def pack_dense_bn(bns, f: int) -> torch.Tensor:
    """The three (mul, add) pairs as one zero-padded (6, F) f32 tensor:
    rows mul1, add1, mul2, add2, mul3, add3."""
    packed = torch.zeros((6, f), dtype=torch.float32, device=bns[0][0].device)
    for i, (mul, add) in enumerate(bns):
        packed[2 * i, : mul.shape[0]] = mul
        packed[2 * i + 1, : add.shape[0]] = add
    return packed


def _unpack_bn(packed: torch.Tensor) -> list[BnPair]:
    f = packed.shape[1]
    return [(packed[2 * i, :c], packed[2 * i + 1, :c]) for i, c in enumerate((f, f // 2, f // 4))]


def fused_dense_block(x, k1, k2, k3, *bn) -> torch.Tensor:
    """Whole DenseConvBlock on an NHWC batch.  ``k1..k3`` are the kernels
    (3,3,F,F/2), (3,3,F/2,F/4), (3,3,F/4,F/4), each HWIO in the compute
    dtype or packed by :func:`ops.winograd.pack_conv3x3_weight`; ``bn``
    is the three (mul, add) f32 pairs, or their :func:`pack_dense_bn`.
    HWIO kernels and pairs are packed on every call: a caller that reuses
    them packs once (``models/fan.py::DenseConvBlock``).  CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    b, h, w, f = x.shape
    cins = (f, f // 2, f // 4)
    if x.device.type != "cuda":
        ks = [unpack_conv3x3_weight(k, c) if k.ndim == 5 else k for k, c in zip((k1, k2, k3), cins)]
        return dense_block_ref(x, *ks, *(_unpack_bn(bn[0]) if len(bn) == 1 else bn))
    if not dense_block_supported(x):
        raise ValueError(
            f"denseblock kernel takes bf16 NHWC input with 128 or 256 channels, "
            f"got {x.dtype} {tuple(x.shape)}"
        )
    ks = []
    for k, c, kout in zip((k1, k2, k3), cins, (f // 2, f // 4, f // 4)):
        packed = k.ndim == 5
        want = (9, -(-c // 64), kout, 8, 8) if packed else (3, 3, c, kout)
        if tuple(k.shape) != want or k.dtype != torch.bfloat16 or k.device != x.device:
            raise ValueError(f"denseblock kernel weight must be bf16 {want} on {x.device}, got "
                             f"{k.dtype} {tuple(k.shape)}")
        ks.append(k.contiguous() if packed else pack_conv3x3_weight(k))
    bn = bn[0] if len(bn) == 1 else pack_dense_bn(bn, f)
    if tuple(bn.shape) != (6, f) or bn.dtype != torch.float32 or bn.device != x.device:
        raise ValueError(f"denseblock BN must be (6, {f}) f32 on {x.device}")
    x, bn = x.contiguous(), bn.contiguous()
    out = torch.empty_like(x)
    scratch = torch.empty(b * h * w * (f + f // 2), dtype=x.dtype, device=x.device)
    lib = _build.load("denseblock", _SIGS)
    err = lib.denseblock(
        x.data_ptr(), ks[0].data_ptr(), ks[1].data_ptr(), ks[2].data_ptr(), bn.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), b, h, w, f,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "denseblock")
    fused_dense_block.launches += 1
    return out


fused_dense_block.launches = 0
