"""SSIM and PSNR of NHWC image batches in [0, 1].

Port of ``ppvision_tpu/metrics/psnr_ssim.py`` (the reference's
``pytorch_ssim``, ``Image_Caption/pytorch_ssim/__init__.py:8-79``): a
per-channel 11x11 Gaussian window (sigma 1.5) with zero SAME padding,
C1 = 0.01^2, C2 = 0.03^2, the mean over everything.  The blur is a
depthwise ``F.conv2d``: two 1-D passes at f32 and bf16, the 2-D
outer-product window at f64.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["gaussian_window", "ssim", "psnr"]


def gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """1-D Gaussian window, normalized to sum 1 (float32).

    Scalar ``math.exp`` (``np.exp``'s SIMD path differs by ~1 ulp, which
    SSIM's variance cancellation amplifies), rounded to f32 before an
    f64-accumulated sum, as torch's f32 ``.sum()`` in ``pytorch_ssim``
    gives it."""
    g = np.array(
        [math.exp(-((i - size // 2) ** 2) / float(2 * sigma**2)) for i in range(size)],
        dtype=np.float32,
    )
    return g / np.float32(g.astype(np.float64).sum())


def _depthwise(x: torch.Tensor, k: np.ndarray, padding) -> torch.Tensor:
    """Depthwise conv of NCHW ``x`` with one (kh, kw) kernel on every
    channel, zero padding."""
    c = x.shape[1]
    w = torch.from_numpy(k).to(device=x.device, dtype=x.dtype)[None, None].expand(c, 1, *k.shape)
    return F.conv2d(x, w, padding=padding, groups=c)


def _gauss_filter(x: torch.Tensor, win: np.ndarray) -> torch.Tensor:
    """Separable blur: the window along H, then along W."""
    pad = len(win) // 2
    x = _depthwise(x, win[:, None], (pad, 0))
    return _depthwise(x, win[None, :], (0, pad))


def _gauss_filter_2d(x: torch.Tensor, win: np.ndarray) -> torch.Tensor:
    """The f32-rounded 2-D outer-product window (``pytorch_ssim``'s
    ``create_window``), cast to the input's dtype."""
    w = win.astype(np.float32)
    pad = len(win) // 2
    return _depthwise(x, np.outer(w, w).astype(np.float32), (pad, pad))


def ssim(
    img1: torch.Tensor,
    img2: torch.Tensor,
    window_size: int = 11,
    sigma: float = 1.5,
    size_average: bool = True,
) -> torch.Tensor:
    """SSIM of two NHWC batches in [0, 1]: a scalar, or one value an
    image with ``size_average=False``."""
    win = gaussian_window(window_size, sigma)
    gf = _gauss_filter_2d if img1.dtype == torch.float64 else _gauss_filter
    a, b = img1.permute(0, 3, 1, 2), img2.permute(0, 3, 1, 2)
    mu1, mu2 = gf(a, win), gf(b, win)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1 = gf(a * a, win) - mu1_sq
    sigma2 = gf(b * b, win) - mu2_sq
    sigma12 = gf(a * b, win) - mu12
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / ((mu1_sq + mu2_sq + c1) * (sigma1 + sigma2 + c2))
    if size_average:
        return torch.mean(ssim_map)
    return torch.mean(ssim_map, dim=(1, 2, 3))


def psnr(img1: torch.Tensor, img2: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB over the whole batch."""
    mse = torch.mean((img1 - img2) ** 2)
    return 10.0 * torch.log10(max_val**2 / torch.clamp(mse, min=1e-12))
