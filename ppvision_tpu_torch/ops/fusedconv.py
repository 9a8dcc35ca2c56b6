"""Resample + 3x3 conv pairs as one 4x4 stride-2 convolution (NCHW).

Port of ``ppvision_tpu/ops/fusedconv.py`` (StarGAN blocks, reference
``core/model.py:58-109``): ``nearest-up2x -> conv3x3`` is one 4x4/s2
transposed conv and ``conv3x3 -> avgpool2x`` one 4x4/s2 conv, both on
the low-resolution side (2.25x fewer FLOPs, same math).  The 4x4
kernels are summed from the f32 (O, I, 3, 3) master in f32 exactly as
``fusedconv.py:74-103`` sums them, then cast to the input dtype.
Float64 inputs run the unfused pair, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .image import avg_pool_2x, upsample_nearest_2x

__all__ = ["conv3x3_nearest_up2x", "conv3x3_avgpool2x", "up2x_kernel", "down2x_kernel"]


def up2x_kernel(weight: torch.Tensor) -> torch.Tensor:
    """(4, 4, I, O) HWIO phase-summed kernel of nearest-up2x -> conv3x3,
    from an (O, I, 3, 3) master: K4 = [K0, K0+K1, K1+K2, K2] along rows
    and columns."""
    k = weight.permute(2, 3, 1, 0)  # HWIO
    kr = torch.stack([k[0], k[0] + k[1], k[1] + k[2], k[2]], 0)
    return torch.stack([kr[:, 0], kr[:, 0] + kr[:, 1], kr[:, 1] + kr[:, 2], kr[:, 2]], 1)


def down2x_kernel(weight: torch.Tensor) -> torch.Tensor:
    """(4, 4, I, O) HWIO kernel of conv3x3 -> avgpool2x (with the 1/4)."""
    k = weight.permute(2, 3, 1, 0)
    zr = torch.zeros_like(k[:1])
    kr = torch.cat([k, zr], 0) + torch.cat([zr, k], 0)
    zc = torch.zeros_like(kr[:, :1])
    return (torch.cat([kr, zc], 1) + torch.cat([zc, kr], 1)) * 0.25


def conv3x3_nearest_up2x(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``conv3x3(SAME)(nearest_upsample_2x(x))`` without bias, as one
    4x4/s2 transposed conv.  ``jax.lax.conv_transpose(x, K4, (2, 2),
    ((2, 2), (2, 2)))`` does not flip its kernel; ``conv_transpose2d``
    does, so K4 is flipped here and the padding is 1."""
    if x.dtype == torch.float64:
        return F.conv2d(upsample_nearest_2x(x), weight.to(x.dtype), padding=1)
    k4 = up2x_kernel(weight).flip(0, 1).permute(2, 3, 0, 1)  # (I, O, 4, 4)
    return F.conv_transpose2d(x, k4.to(x.dtype), stride=2, padding=1)


def conv3x3_avgpool2x(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``avgpool2x(conv3x3(SAME)(x))`` without bias, as one 4x4/s2 conv."""
    if x.dtype == torch.float64:
        return avg_pool_2x(F.conv2d(x, weight.to(x.dtype), padding=1))
    k4 = down2x_kernel(weight).permute(3, 2, 0, 1)  # (O, I, 4, 4)
    return F.conv2d(x, k4.to(x.dtype), stride=2, padding=1)
