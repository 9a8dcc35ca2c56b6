"""Tensor ops and the hand-written Hopper kernels of the port.

Kernels (each with its plain PyTorch version and a ``launches`` count):

- :func:`fftconv.fftconv_circular` (CUDA, ``csrc/fftconv.cu``)
- :func:`denseblock.fused_dense_block` (CUDA, ``csrc/denseblock.cu``)
- :func:`instats.instance_moments` (Triton)
- :func:`winograd.conv3x3` (CUDA, ``csrc/winograd.cu``)
"""

from .denseblock import dense_block_ref, fused_dense_block
from .fftconv import fftconv_circular, fftconv_circular_ref
from .instats import instance_moments
from .winograd import conv3x3, conv3x3_ref

KERNELS = {
    "fftconv": fftconv_circular,
    "denseblock": fused_dense_block,
    "instats": instance_moments,
    "conv3x3": conv3x3,
}

__all__ = [
    "KERNELS",
    "conv3x3",
    "conv3x3_ref",
    "dense_block_ref",
    "fftconv_circular",
    "fftconv_circular_ref",
    "fused_dense_block",
    "instance_moments",
]
