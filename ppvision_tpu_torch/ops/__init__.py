"""Tensor ops and the hand-written Hopper kernels of the port.

Kernels (each with its plain PyTorch version and a ``launches`` count):

- :func:`fftconv.fftconv_circular` (CUDA, ``csrc/fftconv.cu``)
- :func:`denseblock.fused_dense_block` (CUDA, ``csrc/denseblock.cu``)
- :func:`instats.instance_moments` (CUDA, ``csrc/instats.cu``)
- :func:`winograd.conv3x3` (CUDA, ``csrc/winograd.cu``)
- :func:`corr.local_corr` (CUDA, ``csrc/corr.cu``), RAFT's windowed
  correlation, off the de-id path: the video path's RAFT runs it
"""

from .corr import local_corr, local_corr_ref
from .denseblock import dense_block_ref, fused_dense_block
from .fftconv import fftconv_circular, fftconv_circular_ref
from .instats import instance_moments
from .winograd import conv3x3, conv3x3_ref

KERNELS = {
    "fftconv": fftconv_circular,
    "denseblock": fused_dense_block,
    "instats": instance_moments,
    "conv3x3": conv3x3,
    "corr": local_corr,
}
# The kernels the de-id path (camera -> FAN -> StarGAN) runs.
DEID_KERNELS = ("fftconv", "denseblock", "instats", "conv3x3")

__all__ = [
    "DEID_KERNELS",
    "KERNELS",
    "conv3x3",
    "conv3x3_ref",
    "dense_block_ref",
    "fftconv_circular",
    "fftconv_circular_ref",
    "fused_dense_block",
    "instance_moments",
    "local_corr",
    "local_corr_ref",
]
