"""LPIPS perceptual distance: AlexNet features and learned 1x1 weights.

Port of ``ppvision_tpu/metrics/lpips.py`` (reference
``Face-DeId/metrics/lpips.py``): inputs normalized with the
[-1, 1]-range ImageNet statistics, AlexNet's five post-ReLU feature
maps, each L2-normalized over its channels, the squared difference
weighted by a learned non-negative 1x1 conv, averaged over batch and
pixels, summed over the five layers.  AlexNet is written here (no
torchvision).  The modules keep the reference LPIPS module's
state_dict names (``alexnet.layers.{0,3,6,8,10}``,
``lpips_weights.{i}.main.1.weight``), so its weights load directly;
:func:`lpips_state_dict_from_reference` maps a torchvision AlexNet
state_dict (``features.N``) and ``lpips_weights.ckpt`` onto them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..models.stargan import Conv

__all__ = ["ALEX_CHANNELS", "AlexNetFeatures", "LPIPS", "lpips_state_dict_from_reference"]

# The [-1, 1]-range ImageNet statistics, kept in f64 and rounded to the
# input's dtype at use, as the JAX package canonicalizes them.
_MU = np.array([-0.03, -0.088, -0.188], np.float64)
_SIGMA = np.array([0.458, 0.448, 0.450], np.float64)
ALEX_CHANNELS = (64, 192, 384, 256, 256)
_ALEX_CONVS = (0, 3, 6, 8, 10)  # conv indices inside alexnet.features


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet's ``features`` stack under ``layers``; returns
    the five post-ReLU maps (NCHW)."""

    def __init__(self, dtype=None):
        super().__init__()
        self.layers = nn.Sequential(
            Conv(3, 64, 11, 4, 2, dtype=dtype), nn.ReLU(), nn.MaxPool2d(3, 2),
            Conv(64, 192, 5, 1, 2, dtype=dtype), nn.ReLU(), nn.MaxPool2d(3, 2),
            Conv(192, 384, 3, 1, 1, dtype=dtype), nn.ReLU(),
            Conv(384, 256, 3, 1, 1, dtype=dtype), nn.ReLU(),
            Conv(256, 256, 3, 1, 1, dtype=dtype), nn.ReLU(),
            nn.MaxPool2d(3, 2),
        )

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        fmaps = []
        for layer in self.layers[:-1]:
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                fmaps.append(x)
        return fmaps


class _Conv1x1(nn.Module):
    """The reference's ``Conv1x1``: dropout (identity in eval) and a
    bias-free 1x1 conv to one channel, kept for its key names."""

    def __init__(self, channels: int):
        super().__init__()
        self.main = nn.Sequential(nn.Dropout(0.5), nn.Conv2d(channels, 1, 1, bias=False))


class LPIPS(nn.Module):
    """Perceptual distance of two NHWC batches in [-1, 1]: a scalar, the
    mean over the batch.  The learned weights start at one, as the JAX
    package's init."""

    def __init__(self, dtype=None):
        super().__init__()
        self.alexnet = AlexNetFeatures(dtype=dtype)
        self.lpips_weights = nn.ModuleList(_Conv1x1(c) for c in ALEX_CHANNELS)
        with torch.no_grad():
            for m in self.lpips_weights:
                m.main[1].weight.fill_(1.0)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        mu = torch.tensor(_MU, dtype=x.dtype, device=x.device)
        sigma = torch.tensor(_SIGMA, dtype=x.dtype, device=x.device)
        fx = self.alexnet(((x - mu) / sigma).permute(0, 3, 1, 2))
        fy = self.alexnet(((y - mu) / sigma).permute(0, 3, 1, 2))

        def normalize(f):
            return f * torch.rsqrt(torch.sum(f * f, dim=1, keepdim=True) + 1e-10)

        total = 0.0
        for a, b, lin in zip(fx, fy, self.lpips_weights):
            d = torch.square(normalize(a) - normalize(b))
            w = lin.main[1].weight.flatten().to(d.dtype)
            total = total + torch.mean(torch.einsum("bchw,c->bhw", d, w))
        return total


def lpips_state_dict_from_reference(alexnet_sd, lpips_sd) -> dict[str, torch.Tensor]:
    """A torchvision AlexNet state_dict (``features.N.*``, or ``N.*`` for a
    bare ``features`` stack) and the reference ``lpips_weights.ckpt``
    (``lpips_weights.{i}.main.1.weight``) -> the :class:`LPIPS`
    state_dict."""
    out = {}
    for i in _ALEX_CONVS:
        for p in ("weight", "bias"):
            key = f"features.{i}.{p}" if f"features.{i}.{p}" in alexnet_sd else f"{i}.{p}"
            out[f"alexnet.layers.{i}.{p}"] = torch.as_tensor(alexnet_sd[key])
    for i in range(len(ALEX_CHANNELS)):
        key = f"lpips_weights.{i}.main.1.weight"
        out[key] = torch.as_tensor(lpips_sd[key])
    return out
