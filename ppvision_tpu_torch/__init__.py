"""PyTorch/CUDA port of ``ppvision_tpu`` for NVIDIA Hopper (H100).

The package mirrors the JAX package's layout and names module for
module (``config``, ``optics``, ``ops``, ``models``, ``metrics``,
``data``, ``deid``, ``sample``, ``serve``, ``train``, ``cli``, ``utils``):
the Face-DeId pipeline and the privacy-preserving captioner.  Public entry points take and return the JAX
package's NHWC layout; inside, modules run NCHW tensors in
``torch.channels_last`` memory format, which hands the hand-written
Hopper kernels (``csrc/``) NHWC bytes without copies.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; on a CPU tensor every kernel wrapper takes its plain
PyTorch version, on a CUDA tensor it launches its kernel or raises.

This package imports torch and numpy only: never jax, flax or
``ppvision_tpu``.
"""

from .config import CameraConfig, CaptionConfig, FaceDeIdConfig, ModelConfig

__all__ = ["CameraConfig", "CaptionConfig", "FaceDeIdConfig", "ModelConfig"]
