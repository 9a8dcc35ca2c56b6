"""Configuration dataclasses of the de-identification pipeline.

Own copy of the model and camera sections of ``ppvision_tpu/config.py``
(the reference's ``Face-DeId/main.py:88-112`` flags and
``Camera/Optics.py:10-36`` geometry); defaults are identical.  The
training, loss and path sections join when the training slice is
ported.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Reference main.py:88-112."""

    img_size: int = 256
    num_domains: int = 2
    latent_dim: int = 16
    hidden_dim: int = 512
    style_dim: int = 64
    w_hpf: float = 1.0
    max_conv_dim: int = 512
    # FAN runs at this input resolution in the module tests; the de-id
    # pipeline always resizes to 256 like the reference (wing.py:244).
    fan_input_size: int = 256
    # Compute dtype of the conv nets (params stay float32).
    compute_dtype: str = "bfloat16"
    # int8 decoder serving mode: not ported yet; the port raises if set.
    quant_decode: bool = False


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Face-DeId camera (reference Camera/Optics.py:10-36)."""

    n: int = 256
    zernike_terms: int = 300
    height_tolerance: float = 2e-8


@dataclasses.dataclass(frozen=True)
class FaceDeIdConfig:
    model: ModelConfig = ModelConfig()
    camera: CameraConfig = CameraConfig()
