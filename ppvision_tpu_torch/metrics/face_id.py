"""Face-identity embedding and the cosine-similarity leakage metric.

Port of ``ppvision_tpu/metrics/face_id.py``: an ArcFace IResNet (the
insightface architecture: 112x112 input in [-1, 1], 512-d output) and
the cosine that scores how much identity the anonymization leaves (lower
|cos| is better de-identification) or how stable identity is across
reruns.  The modules keep insightface's ``iresnet`` state_dict names, so
an ``iresnet50`` checkpoint loads straight in; its ``fc`` flattens NCHW
as torch does.

Two preprocessing modes, as in the JAX package:

- :func:`make_embed_fn` resizes the whole frame to 112x112 (bilinear,
  antialiased when it shrinks, as ``jax.image.resize``): self-consistent
  for parity, not comparable to published ArcFace numbers;
- :func:`make_aligned_embed_fn` runs FAN landmarks, a 5-point
  similarity solve to the ArcFace 112x112 template and a bilinear warp
  on the device before the embed (insightface's ``norm_crop``, no cv2).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.align import heatmap_landmarks
from ..models.fan import NUM_LANDMARKS, FrozenBatchNorm
from ..models.raft import bilinear_sampler
from ..ops.image import resize_bilinear

__all__ = [
    "ARCFACE_TEMPLATE",
    "IResNet",
    "face_id_cosine",
    "fan_five_points",
    "make_aligned_embed_fn",
    "make_embed_fn",
    "similarity_from_points",
    "warp_to_template",
]


def _conv3x3(c_in: int, c_out: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, 3, stride, 1, bias=False)


class IBasicBlock(nn.Module):
    """insightface IBasicBlock: BN-conv-BN-PReLU-conv(stride)-BN, plus the
    input (through a strided 1x1 conv and BN where ``downsample``)."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.bn1 = FrozenBatchNorm(c_in)
        self.conv1 = _conv3x3(c_in, c_out)
        self.bn2 = FrozenBatchNorm(c_out)
        self.prelu = nn.PReLU(c_out)
        self.conv2 = _conv3x3(c_out, c_out, stride)
        self.bn3 = FrozenBatchNorm(c_out)
        self.downsample = (
            nn.Sequential(nn.Conv2d(c_in, c_out, 1, stride, bias=False), FrozenBatchNorm(c_out)) if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn3(self.conv2(self.prelu(self.bn2(self.conv1(self.bn1(x))))))
        return out + (x if self.downsample is None else self.downsample(x))


class IResNet(nn.Module):
    """ArcFace IResNet: (B, 112, 112, 3) NHWC in [-1, 1] -> (B, 512).
    ``layers=(3, 4, 14, 3)`` is iresnet50.  Every BatchNorm runs from its
    running statistics (eps 1e-5)."""

    WIDTHS = (64, 128, 256, 512)

    def __init__(self, layers: tuple[int, ...] = (3, 4, 14, 3), embed_dim: int = 512):
        super().__init__()
        self.conv1 = _conv3x3(3, 64)
        self.bn1 = FrozenBatchNorm(64)
        self.prelu = nn.PReLU(64)
        c_in = 64
        for li, (w, n) in enumerate(zip(self.WIDTHS, layers), start=1):
            blocks = [IBasicBlock(c_in, w, stride=2, downsample=True)]
            blocks += [IBasicBlock(w, w) for _ in range(n - 1)]
            self.add_module(f"layer{li}", nn.Sequential(*blocks))
            c_in = w
        self.bn2 = FrozenBatchNorm(c_in)
        # 112 / 2^4 = 7: the last stage's map is 7x7.
        self.fc = nn.Linear(c_in * 7 * 7, embed_dim)
        self.features = FrozenBatchNorm(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.prelu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = self.fc(self.bn2(x).flatten(1).float())
        mul, add = self.features.fold()
        return x * mul + add


def _unit(e: torch.Tensor) -> torch.Tensor:
    return e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-10)


def make_embed_fn(model: IResNet):
    """NHWC [0, 1] face batch (any square size) -> unit 512-d embeddings:
    the frame resized to 112x112 (bilinear, half-pixel centres,
    antialiased when it shrinks: ``jax.image.resize``'s "bilinear")."""

    @torch.no_grad()
    def embed(x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(112, 112), mode="bilinear", align_corners=False, antialias=True)
        return _unit(model((x * 2.0 - 1.0).permute(0, 2, 3, 1)))

    return embed


def face_id_cosine(embed_fn, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean cosine similarity between embeddings of two face batches."""
    return torch.mean(torch.sum(embed_fn(a) * embed_fn(b), dim=-1))


# Canonical ArcFace 112x112 destination template (insightface
# ``face_align.arcface_dst``): left eye, right eye, nose tip, left and
# right mouth corners.
ARCFACE_TEMPLATE = np.array(
    [
        [38.2946, 51.6963],
        [73.5318, 51.5014],
        [56.0252, 71.7366],
        [41.5493, 92.3655],
        [70.7299, 92.2041],
    ],
    dtype=np.float32,
)

# 98-point FAN (WFLW layout, the reference aligner's, wing.py:353-380):
# eye rings 60-67 / 68-75 with centres 96 / 97, nose tip 54, mouth
# corners 76 / 82.
_EYE_L_IDX = list(range(60, 68)) + [96]
_EYE_R_IDX = list(range(68, 76)) + [97]
_NOSE_TIP, _MOUTH_L, _MOUTH_R = 54, 76, 82


def fan_five_points(landmarks: torch.Tensor) -> torch.Tensor:
    """(..., 98, 2) FAN landmarks -> (..., 5, 2) ArcFace points; each eye
    the mean of its ring and centre (wing.py:357-361)."""
    return torch.stack(
        [
            landmarks[..., _EYE_L_IDX, :].mean(dim=-2),
            landmarks[..., _EYE_R_IDX, :].mean(dim=-2),
            landmarks[..., _NOSE_TIP, :],
            landmarks[..., _MOUTH_L, :],
            landmarks[..., _MOUTH_R, :],
        ],
        dim=-2,
    )


def similarity_from_points(src: torch.Tensor, dst: torch.Tensor):
    """Least-squares non-reflective similarity ``src -> dst`` in closed
    form: with ``[x', y'] = [[a, -b], [b, a]] @ [x, y] + t`` over centred
    points, ``a = sum(sc . dc) / sum(|sc|^2)`` and ``b = sum(cross(sc,
    dc)) / sum(|sc|^2)``.  Returns ``(A, t)``, (..., 2, 2) and (..., 2),
    for point sets of shape (..., N, 2)."""
    sm = src.mean(dim=-2, keepdim=True)
    dm = dst.mean(dim=-2, keepdim=True)
    sc, dc = src - sm, dst - dm
    denom = torch.sum(sc * sc, dim=(-2, -1)) + 1e-12
    a = torch.sum(sc * dc, dim=(-2, -1)) / denom
    b = torch.sum(sc[..., 0] * dc[..., 1] - sc[..., 1] * dc[..., 0], dim=-1) / denom
    mat = torch.stack([torch.stack([a, -b], dim=-1), torch.stack([b, a], dim=-1)], dim=-2)
    t = dm[..., 0, :] - torch.einsum("...ij,...j->...i", mat, sm[..., 0, :])
    return mat, t


def warp_to_template(img: torch.Tensor, src_points: torch.Tensor, dst_points=None, out_size: int = 112) -> torch.Tensor:
    """Similarity-warp NHWC ``img`` so ``src_points`` (B, 5, 2) land on
    ``dst_points`` (``ARCFACE_TEMPLATE`` by default), bilinear, zeros
    outside.  The inverse map is analytic: ``A^-1 = adj(A) / (a^2 +
    b^2)`` for a similarity."""
    if dst_points is None:
        dst_points = torch.from_numpy(ARCFACE_TEMPLATE)
    dst = torch.as_tensor(dst_points, dtype=src_points.dtype, device=src_points.device).expand(src_points.shape)
    mat, t = similarity_from_points(src_points, dst)
    det = mat[..., 0, 0] ** 2 + mat[..., 1, 0] ** 2
    inv = torch.stack(
        [
            torch.stack([mat[..., 1, 1], -mat[..., 0, 1]], dim=-1),
            torch.stack([-mat[..., 1, 0], mat[..., 0, 0]], dim=-1),
        ],
        dim=-2,
    ) / det[..., None, None]
    r = torch.arange(out_size, dtype=torch.float32, device=img.device)
    ys, xs = torch.meshgrid(r, r, indexing="ij")
    rel = torch.stack([xs, ys], dim=-1)[None] - t[:, None, None, :]
    return bilinear_sampler(img, torch.einsum("bij,bhwj->bhwi", inv, rel))


def make_aligned_embed_fn(model: IResNet, fan, input_size: int = 256):
    """NHWC [0, 1] frames of any square size -> unit 512-d embeddings via
    FAN landmarks and the template warp.  ``input_size`` is the FAN's
    working resolution (256 is the reference's, wing.py:244)."""

    @torch.no_grad()
    def embed(x: torch.Tensor) -> torch.Tensor:
        xr = resize_bilinear(x.permute(0, 3, 1, 2), (input_size, input_size))
        out = fan(xr).float().permute(0, 2, 3, 1)
        lm = heatmap_landmarks(out[..., :NUM_LANDMARKS]) * 4.0
        face = warp_to_template(xr.permute(0, 2, 3, 1), fan_five_points(lm))
        return _unit(model(face * 2.0 - 1.0))

    return embed
