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

For evaluation, :func:`make_pairwise_lpips_fn` gives every pairwise
distance among a group of outputs from one AlexNet pass over the group
(the reference's ``calculate_lpips_given_images``, lpips.py:75-88).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..models.stargan import Conv

__all__ = [
    "ALEX_CHANNELS",
    "AlexNetFeatures",
    "LPIPS",
    "calculate_lpips_given_images",
    "lpips_state_dict_from_reference",
    "make_pairwise_lpips_fn",
]

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

    def features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The five channel-normalized AlexNet maps (NCHW) of an NHWC batch."""
        mu = torch.tensor(_MU, dtype=x.dtype, device=x.device)
        sigma = torch.tensor(_SIGMA, dtype=x.dtype, device=x.device)
        fs = self.alexnet(((x - mu) / sigma).permute(0, 3, 1, 2))
        return [f * torch.rsqrt(torch.sum(f * f, dim=1, keepdim=True) + 1e-10) for f in fs]

    def distance(self, fa: list[torch.Tensor], fb: list[torch.Tensor]) -> torch.Tensor:
        """The distance of two sets of normalized maps with leading dims
        (..., C, H, W), averaged over their last leading dim and the
        pixels: shape ``(...)`` less that dim."""
        total = 0.0
        for a, b, lin in zip(fa, fb, self.lpips_weights):
            d = torch.square(a - b)
            w = lin.main[1].weight.flatten().to(d.dtype)
            total = total + torch.mean(torch.einsum("...chw,c->...hw", d, w), dim=(-3, -2, -1))
        return total

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.distance(self.features(x), self.features(y))


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


def make_pairwise_lpips_fn(lpips: LPIPS, num_outs: int):
    """All pairwise distances among a group of outputs:
    ``fn(fakes: (R, B, H, W, 3)) -> (C(R, 2),)``, in ``np.triu_indices(R,
    k=1)`` order, the values of the reference's pairwise loop
    (lpips.py:75-88).  AlexNet runs once over the R*B outputs, and the
    pairs reduce over the cached, normalized features."""
    ii, jj = (torch.from_numpy(t) for t in np.triu_indices(num_outs, k=1))

    @torch.no_grad()
    def pairwise(fakes: torch.Tensor) -> torch.Tensor:
        r, b = fakes.shape[:2]
        feats = [f.reshape(r, b, *f.shape[1:]) for f in lpips.features(fakes.reshape(r * b, *fakes.shape[2:]))]
        i, j = ii.to(fakes.device), jj.to(fakes.device)
        return lpips.distance([f[i] for f in feats], [f[j] for f in feats])

    return pairwise


def calculate_lpips_given_images(lpips: LPIPS, group_of_images: list) -> float:
    """Mean pairwise LPIPS across a group of outputs for the same input
    (reference lpips.py:75-88); 0 for fewer than two."""
    if len(group_of_images) < 2:
        return 0.0
    fakes = torch.stack([torch.as_tensor(g) for g in group_of_images])
    return float(make_pairwise_lpips_fn(lpips, len(group_of_images))(fakes).mean())
