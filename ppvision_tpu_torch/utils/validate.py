"""Shape/dtype guards for public API edges (own copy of
``ppvision_tpu/utils/validate.py``): fail with a clear message instead
of a deep shape error inside a conv."""

from __future__ import annotations

import torch

__all__ = ["check_image_batch", "check_labels"]


def check_image_batch(x: torch.Tensor, name: str, channels: int = 3, size: int | None = None):
    """NHWC float image batch; optionally a fixed square size."""
    if x.ndim != 4:
        raise ValueError(
            f"{name}: expected NHWC batch (4 dims), got shape {tuple(x.shape)}"
        )
    if x.shape[-1] != channels:
        raise ValueError(
            f"{name}: expected {channels} channels last (NHWC), got shape "
            f"{tuple(x.shape)} — is this NCHW? permute(0, 2, 3, 1) first"
        )
    if size is not None and (x.shape[1] != size or x.shape[2] != size):
        raise ValueError(
            f"{name}: expected {size}x{size} images, got {tuple(x.shape)}"
        )
    if not x.dtype.is_floating_point:
        raise ValueError(
            f"{name}: expected float dtype in [0, 1], got {x.dtype} — "
            "divide uint8 images by 255 first"
        )


def check_labels(y: torch.Tensor, name: str, batch: int | None = None):
    """1-D integer domain labels."""
    if y.ndim != 1:
        raise ValueError(f"{name}: expected 1-D labels, got shape {tuple(y.shape)}")
    if y.dtype.is_floating_point or y.dtype.is_complex or y.dtype == torch.bool:
        raise ValueError(f"{name}: expected integer labels, got {y.dtype}")
    if batch is not None and y.shape[0] != batch:
        raise ValueError(
            f"{name}: batch mismatch — labels {y.shape[0]} vs images {batch}"
        )
