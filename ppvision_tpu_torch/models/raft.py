"""RAFT optical flow (PyTorch, NCHW inside) for video temporal consistency.

Port of ``ppvision_tpu/models/raft.py`` (reference
``Face-DeId/RAFT/core/{raft,extractor,corr,update}.py``): BasicEncoder
feature and context nets, the all-pairs correlation pyramid with its
bilinear radius-r lookup or the on-demand windowed correlation
(``alternate_corr=True``, kernel 5 through
:func:`ops.corr.alternate_corr_lookup`), the SepConvGRU update block and
convex 8x upsampling.  Module attributes give the reference's
state_dict keys (``fnet.layer2.0.downsample.1``,
``update_block.gru.convq2``, ...), so raft-things.pth loads directly.

Public functions take and return NHWC tensors like the JAX package's;
the networks run NCHW.  Everything is f32: the norms are written as the
JAX package's formulas (instance norm without affine over (H, W), eps
1e-5; cnet's BatchNorm frozen at its running statistics).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.corr import alternate_corr_lookup
from ..ops.image import avg_pool_2x, resize_bilinear
from ..utils.device import resolve_device
from .stargan import init_params_

__all__ = [
    "RAFT",
    "bilinear_sampler",
    "build_corr_pyramid",
    "build_raft",
    "convex_upsample",
    "coords_grid",
    "lookup_corr_pyramid",
    "raft_flow_loss",
    "upflow8",
]


# ---------------------------------------------------------------------------
# Sampling helpers (NHWC).
# ---------------------------------------------------------------------------


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup of NHWC ``img`` at pixel ``coords`` (B, ..., 2) =
    (x, y), zeros outside (grid_sample align_corners=True, zero padding)."""
    h, w = img.shape[-3], img.shape[-2]
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    bidx = torch.arange(img.shape[0], device=img.device).reshape((-1,) + (1,) * (coords.ndim - 2))

    def gather(yy, xx):
        valid = (xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= h - 1)
        vals = img[bidx, yy.clamp(0, h - 1).long(), xx.clamp(0, w - 1).long()]
        return vals * valid[..., None]

    return (
        gather(y0, x0) * ((1 - wx) * (1 - wy))[..., None]
        + gather(y0, x0 + 1) * (wx * (1 - wy))[..., None]
        + gather(y0 + 1, x0) * ((1 - wx) * wy)[..., None]
        + gather(y0 + 1, x0 + 1) * (wx * wy)[..., None]
    )


def coords_grid(batch: int, h: int, w: int, device=None) -> torch.Tensor:
    """(B, H, W, 2) grid of (x, y) pixel coordinates, f32."""
    ys, xs = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device), indexing="ij")
    return torch.stack([xs, ys], -1).float().expand(batch, h, w, 2)


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """8x bilinear upsample (align_corners) of an NHWC flow, values x 8."""
    h, w = flow.shape[1] * 8, flow.shape[2] * 8
    return 8.0 * resize_bilinear(flow.permute(0, 3, 1, 2), (h, w), align_corners=True).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Correlation pyramid (CorrBlock, corr.py:12-60).
# ---------------------------------------------------------------------------


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4) -> list[torch.Tensor]:
    """All-pairs correlation of NHWC feature maps -> list of
    (B*H1*W1, H2/2^l, W2/2^l): the JAX package's pyramid without its
    trailing 1-channel axis."""
    b, h1, w1, c = fmap1.shape
    h2, w2 = fmap2.shape[1:3]
    corr = torch.matmul(fmap1.reshape(b, h1 * w1, c), fmap2.reshape(b, h2 * w2, c).transpose(1, 2))
    corr = corr.reshape(b * h1 * w1, h2, w2) / math.sqrt(c)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        corr = avg_pool_2x(corr)
        pyramid.append(corr)
    return pyramid


def lookup_corr_pyramid(pyramid: list[torch.Tensor], coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Radius-r bilinear lookup at each level -> (B, H, W, L*(2r+1)^2),
    in the reference CorrBlock's x-major K^2 order.  The hat function
    max(0, 1 - |x - q|) over grid columns q is zero-padded bilinear
    sampling, so the window lookup is two small batched matmuls a level,
    as in the JAX package."""
    b, h, w, _ = coords.shape
    off = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords.device)
    cx = coords.reshape(-1, 2)[:, 0]
    cy = coords.reshape(-1, 2)[:, 1]
    out = []
    for i, corr in enumerate(pyramid):
        hl, wl = corr.shape[1], corr.shape[2]
        sx, sy = cx / (2**i), cy / (2**i)
        q = torch.arange(wl, dtype=torch.float32, device=coords.device)
        p = torch.arange(hl, dtype=torch.float32, device=coords.device)
        wcol = torch.clamp_min(1.0 - torch.abs(sx[:, None, None] + off[None, :, None] - q[None, None, :]), 0.0)
        wrow = torch.clamp_min(1.0 - torch.abs(sy[:, None, None] + off[None, :, None] - p[None, None, :]), 0.0)
        t = torch.einsum("npq,naq->nap", corr, wcol)
        # sampled[n, a, b]: row cy + off[b], column cx + off[a] (x-major).
        sampled = torch.einsum("nap,nbp->nab", t, wrow)
        out.append(sampled.reshape(b, h, w, -1))
    return torch.cat(out, dim=-1)


# ---------------------------------------------------------------------------
# Networks (NCHW).
# ---------------------------------------------------------------------------


class _InstanceNorm(nn.Module):
    """torch InstanceNorm2d without affine (no state), as the JAX
    formula: (x - mean) * rsqrt(var + 1e-5) over (H, W)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = torch.square(x - mean).mean(dim=(2, 3), keepdim=True)
        return (x - mean) * torch.rsqrt(var + 1e-5)


class _FrozenBN(nn.BatchNorm2d):
    """BatchNorm2d at its running statistics, as the JAX formula:
    (x - mean) * rsqrt(var + eps) * scale + bias."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var, scale, bias = (
            t[:, None, None] for t in (self.running_mean, self.running_var, self.weight, self.bias)
        )
        return (x - mean) * torch.rsqrt(var + self.eps) * scale + bias


def _norm(kind: str, planes: int) -> nn.Module:
    return _InstanceNorm() if kind == "instance" else _FrozenBN(planes)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm: str, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1 = _norm(norm, planes)
        self.norm2 = _norm(norm, planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            # The reference registers this norm as both ``norm3`` and
            # ``downsample.1``; its state_dict carries both keys.
            self.norm3 = _norm(norm, planes)
            self.downsample = nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """Feature / context trunk at 1/8 resolution (extractor.py:118-192)."""

    def __init__(self, output_dim: int = 256, norm: str = "instance"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = _norm(norm, 64)
        layers, cin = [], 64
        for dim, stride in ((64, 1), (96, 2), (128, 2)):
            layers.append(nn.Sequential(ResidualBlock(cin, dim, norm, stride), ResidualBlock(dim, dim, norm, 1)))
            cin = dim
        self.layer1, self.layer2, self.layer3 = layers
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class _MatmulConv2d(nn.Conv2d):
    """A stride-1 SAME ``nn.Conv2d`` that runs as unfold + one batched
    f32 matmul on CUDA.  For the motion encoder's 3x3 256->192 and
    256->126 convs cuDNN's f32 heuristics (TF32 off) pick an FFT-tiled
    algorithm some 20x slower than this (PERF.md, Findings)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cuda":
            return super().forward(x)
        b, _, h, w = x.shape
        cols = F.unfold(x, self.kernel_size, padding=self.padding)  # (B, C*kh*kw, H*W)
        y = torch.matmul(self.weight.reshape(self.out_channels, -1), cols) + self.bias[:, None]
        return y.reshape(b, self.out_channels, h, w)


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_planes, 256, 1)
        self.convc2 = _MatmulConv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = _MatmulConv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)  # 128 channels


class SepConvGRU(nn.Module):
    """GRU with a (1, 5) then a (5, 1) pass (update.py:29-55)."""

    def __init__(self, hidden: int = 128, input_dim: int = 256):
        super().__init__()
        cin = hidden + input_dim
        for tag, k, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{tag}", nn.Conv2d(cin, hidden, k, padding=pad))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for tag in "12":
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{tag}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{tag}")(hx))
            q = torch.tanh(getattr(self, f"convq{tag}")(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden, 2, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    def __init__(self, corr_planes: int, hidden: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes)
        self.gru = SepConvGRU(hidden, 128 + hidden)
        self.flow_head = FlowHead(hidden, 256)
        self.mask = nn.Sequential(nn.Conv2d(hidden, 256, 3, padding=1), nn.ReLU(), nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        # The convex-upsampling mask is scaled .25 to balance gradients.
        return net, 0.25 * self.mask(net), self.flow_head(net)


def _convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """NCHW convex 8x upsampling (raft.py:74-85): mask channel
    k*64 + dy*8 + dx weighs neighbour k of the 3x3 window of 8*flow."""
    b, _, h, w = flow.shape
    mask = torch.softmax(mask.reshape(b, 1, 9, 8, 8, h, w), dim=2)
    pad = F.pad(8.0 * flow, (1, 1, 1, 1))
    patches = torch.stack([pad[:, :, i : i + h, j : j + w] for i in range(3) for j in range(3)], dim=2)
    up = torch.sum(mask * patches[:, :, :, None, None], dim=2)  # (B, 2, 8, 8, H, W)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(b, 2, 8 * h, 8 * w)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """NHWC flow (B, H, W, 2) and mask (B, H, W, 576) -> (B, 8H, 8W, 2)."""
    return _convex_upsample(flow.permute(0, 3, 1, 2), mask.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class RAFT(nn.Module):
    """Full-size RAFT; images NHWC in [0, 255] -> final flow (B, H, W, 2).

    ``alternate_corr`` computes each correlation window on demand with
    kernel 5 (the reference's ``--alternate_corr`` / alt_cuda_corr path)
    instead of the O((HW)^2) dense pyramid: one launch per level per
    refinement iteration."""

    def __init__(
        self,
        iters: int = 12,
        corr_levels: int = 4,
        corr_radius: int = 4,
        hidden_dim: int = 128,
        context_dim: int = 128,
        alternate_corr: bool = False,
    ):
        super().__init__()
        self.iters = iters
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.hidden_dim = hidden_dim
        self.context_dim = context_dim
        self.alternate_corr = alternate_corr
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(hidden_dim + context_dim, "batch")
        self.update_block = BasicUpdateBlock(corr_levels * (2 * corr_radius + 1) ** 2, hidden_dim)

    def _lookup(self, fmap1, fmap2, pyramid, coords):
        if pyramid is not None:
            return lookup_corr_pyramid(pyramid, coords, self.corr_radius)
        corr = alternate_corr_lookup(fmap1, fmap2, coords, self.corr_levels, self.corr_radius)
        # The kernel's K^2 blocks are (dy, dx); the dense pyramid (and
        # converted update-block weights) use (dx, dy): swap per level.
        b, h, w, _ = corr.shape
        kk = 2 * self.corr_radius + 1
        return corr.reshape(b, h, w, self.corr_levels, kk, kk).transpose(-1, -2).reshape(b, h, w, -1)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor, iters: int | None = None) -> torch.Tensor:
        iters = iters or self.iters
        x1 = (2.0 * (image1 / 255.0) - 1.0).permute(0, 3, 1, 2)
        x2 = (2.0 * (image2 / 255.0) - 1.0).permute(0, 3, 1, 2)
        fmap1, fmap2 = self.fnet(torch.cat([x1, x2], dim=0)).permute(0, 2, 3, 1).contiguous().chunk(2, dim=0)
        pyramid = None if self.alternate_corr else build_corr_pyramid(fmap1, fmap2, self.corr_levels)

        net, inp = torch.split(self.cnet(x1), [self.hidden_dim, self.context_dim], dim=1)
        net, inp = torch.tanh(net), F.relu(inp)

        b, h, w, _ = fmap1.shape
        # The grid's values are integers: the same in f32 and in the
        # features' dtype, which the update block's convs need.
        coords0 = coords_grid(b, h, w, fmap1.device).to(fmap1.dtype)
        coords1 = coords0
        for _ in range(iters):
            coords1 = coords1.detach()
            corr = self._lookup(fmap1, fmap2, pyramid, coords1)
            flow = (coords1 - coords0).permute(0, 3, 1, 2)
            net, mask, delta = self.update_block(net, inp, corr.permute(0, 3, 1, 2), flow)
            coords1 = coords1 + delta.permute(0, 2, 3, 1)
        # The JAX package upsamples every iteration and returns the last.
        return _convex_upsample((coords1 - coords0).permute(0, 3, 1, 2), mask).permute(0, 2, 3, 1)


def raft_flow_loss(raft: RAFT, frames1: torch.Tensor, frames2: torch.Tensor, iters: int = 20) -> torch.Tensor:
    """Temporal-consistency loss: sum over the batch of |mean(flow)|
    between frame pairs (reference loss_RAFT.__call__, utils.py:460-462),
    batched.  The gradient reaches the frames; RAFT's own weights stay
    frozen (``build_raft``), and each refinement step detaches its
    coordinates as the reference does."""
    flow = raft(frames1, frames2, iters=iters)
    return torch.sum(torch.abs(torch.mean(flow, dim=(1, 2, 3))))


def build_raft(seed: int = 0, device="cuda", **cfg) -> RAFT:
    """A ``RAFT(**cfg)`` with fresh seeded weights (conv weights
    ~ N(0, 1 / fan_in) as Flax's LeCun init, zero biases, unit/zero
    frozen-BN statistics), frozen and in eval mode, on the card unless
    ``device="cpu"``.  Load raft-things.pth or carried-over weights with
    ``load_state_dict``."""
    dev = resolve_device(device)
    raft = init_params_(RAFT(**cfg), seed, gain=1.0)
    return raft.to(dev).eval().requires_grad_(False)
