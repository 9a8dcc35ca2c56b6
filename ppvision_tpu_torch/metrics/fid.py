"""Frechet Inception Distance: InceptionV3 pool3 features (2048-d).

Port of ``ppvision_tpu/metrics/fid.py`` (reference
``Face-DeId/metrics/fid.py``): the torchvision InceptionV3 up to its
final average pool, activations over 299^2 ImageNet-normalized images,
and the Frechet distance with scipy's ``sqrtm`` on the host
(fid.py:46-69).  The modules keep torchvision's ``inception_v3`` names
(``Conv2d_1a_3x3`` ... ``Mixed_7c``, each ``BasicConv2d`` a bias-free
``conv`` and a ``bn`` with eps 1e-3), so ``checkpoints/inception_v3.pth``
loads straight in; its ``AuxLogits`` and ``fc`` entries are dropped by
name.  The API is NHWC like the JAX package's; the net runs NCHW.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "InceptionV3",
    "collect_activations",
    "compute_statistics",
    "fid_from_activations",
    "frechet_distance",
]


class BasicConv2d(nn.Module):
    """Conv (no bias), BatchNorm (eps 1e-3) from its running statistics
    whatever the module's mode, ReLU."""

    def __init__(self, c_in: int, c_out: int, kernel_size, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel_size, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(c_out, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bn
        return F.relu(F.batch_norm(self.conv(x), bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps))


def _avg3(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 mean pool, zero padding counted (flax ``avg_pool``)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


class InceptionA(nn.Module):
    def __init__(self, c_in: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 64, 1)
        self.branch5x5_1 = BasicConv2d(c_in, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(c_in, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(c_in, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, c_in: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 192, 1)
        self.branch7x7_1 = BasicConv2d(c_in, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(c_in, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(c_in, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = conv(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(c_in, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(c_in, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 320, 1)
        self.branch3x3_1 = BasicConv2d(c_in, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(c_in, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(c_in, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avg3(x))], 1)


class InceptionV3(nn.Module):
    """Feature extractor: (B, 299, 299, 3) normalized NHWC -> (B, 2048)
    f32 pool3 activations (any input of at least 75^2 runs)."""

    # torchvision entries outside the pool3 extractor.
    UNUSED_PREFIXES = ("AuxLogits.", "fc.")

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """A torchvision ``inception_v3`` state_dict, its ``AuxLogits`` and
        ``fc`` entries left out; every other key must match."""
        sd = {k: v for k, v in state_dict.items() if not k.startswith(self.UNUSED_PREFIXES)}
        return super().load_state_dict(sd, strict=strict, assign=assign)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x.permute(0, 3, 1, 2))))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a", "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        return torch.mean(x, dim=(2, 3)).float()


def compute_statistics(acts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return np.mean(acts, axis=0), np.cov(acts, rowvar=False)


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """Host-side Frechet distance (scipy ``sqrtm``, reference
    fid.py:46-69): retried with ``eps`` on the diagonals when the root is
    not finite, its real part taken.  ``sqrtm`` is called without the JAX
    package's ``disp=False``, which newer scipy no longer takes; the root
    is the same."""
    import scipy.linalg

    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(cov1 @ cov2)
    if not np.isfinite(covmean).all():
        offset = np.eye(cov1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((cov1 + offset) @ (cov2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2 * np.trace(covmean))


def fid_from_activations(real: np.ndarray, fake: np.ndarray) -> float:
    return frechet_distance(*compute_statistics(real), *compute_statistics(fake))


@torch.no_grad()
def collect_activations(model: InceptionV3, batches: Iterable) -> np.ndarray:
    """(N, 2048) Inception activations of NHWC batches (numpy arrays or
    tensors), in order, computed on the model's device."""
    dev = next(model.parameters()).device
    outs = [model(torch.as_tensor(b, dtype=torch.float32, device=dev)).cpu().numpy() for b in batches if len(b)]
    return np.concatenate(outs, axis=0)
