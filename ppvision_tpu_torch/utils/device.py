"""Device selection for the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for the CPU.  Raises when CUDA is asked for and absent, instead of
    quietly running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        # The f32 paths (the camera's optics, the float32 compute mode)
        # follow the JAX package's true-f32 math, so TF32 is turned off
        # for cuDNN convolutions and cuBLAS matmuls process-wide.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev
