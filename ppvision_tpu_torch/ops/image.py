"""Image resampling ops with exact ``F.interpolate`` semantics (NCHW).

Port of ``ppvision_tpu/ops/image.py``.  Bilinear resizing is two
separable contractions with static (out, in) interpolation matrices
built in numpy (two nonzeros a row), in f32 for f32/bf16 inputs and f64
for f64 inputs, as the JAX package computes it; the result is cast back
to the input dtype once.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["resize_bilinear", "avg_pool_2x", "upsample_nearest_2x"]


def _bilinear_weights_np(in_size: int, out_size: int, align_corners: bool):
    """Static (lo, hi, w_hi) indices/weights for one axis (float64)."""
    i = np.arange(out_size, dtype=np.float64)
    if align_corners:
        scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        src = i * scale
    else:
        scale = in_size / out_size
        src = np.clip((i + 0.5) * scale - 0.5, 0.0, None)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.clip(lo + 1, 0, in_size - 1)
    return lo, hi, src - lo


@functools.lru_cache(maxsize=64)
def _resize_matrix(in_size: int, out_size: int, align_corners: bool, f64: bool, device: str) -> torch.Tensor:
    """The matrix below as a tensor kept on ``device``, so a resize makes
    no host-to-device copy after the first."""
    return torch.from_numpy(_resize_matrix_np(in_size, out_size, align_corners, f64)).to(device)


@functools.lru_cache(maxsize=64)
def _resize_matrix_np(in_size: int, out_size: int, align_corners: bool, f64: bool) -> np.ndarray:
    """Dense (out, in) bilinear interpolation matrix."""
    lo, hi, w = _bilinear_weights_np(in_size, out_size, align_corners)
    if not f64:
        w = w.astype(np.float32)
    m = np.zeros((out_size, in_size), np.float64 if f64 else np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, lo), 1.0 - w)
    np.add.at(m, (rows, hi), w)
    return m


def resize_bilinear(
    x: torch.Tensor, out_hw: tuple[int, int], align_corners: bool = False
) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor, matching ``F.interpolate``
    (no antialiasing) in both ``align_corners`` modes."""
    h, w = x.shape[-2], x.shape[-1]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    f64 = x.dtype == torch.float64
    wdt = torch.float64 if f64 else torch.float32
    mh = _resize_matrix(h, oh, align_corners, f64, str(x.device))
    mw = _resize_matrix(w, ow, align_corners, f64, str(x.device))
    y = torch.einsum("oh,...hw->...ow", mh, x.to(wdt))
    y = torch.einsum("pw,...ow->...op", mw, y)
    return y.to(x.dtype)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 mean pool of an NCHW tensor: the four taps summed in
    f32 (f64 for f64 input), scaled by 1/4, rounded to the input dtype
    once — the value the JAX package's f32-accumulating pool gives."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    s = xf[..., 0::2, 0::2] + xf[..., 1::2, 0::2] + xf[..., 0::2, 1::2] + xf[..., 1::2, 1::2]
    return (s * 0.25).to(x.dtype)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample (exact duplication)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
