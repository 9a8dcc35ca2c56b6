"""FAN face-landmark heatmap network (PyTorch, NCHW channels_last).

Port of ``ppvision_tpu/models/fan.py`` (reference
``Face-DeId/core/wing.py:36-310``): CoordConv stem, dense ConvBlocks,
one depth-4 hourglass, a 98+1-channel head, and the heatmap
post-processing.  Modules keep the reference state_dict names
(``conv1.conv``, ``bn1``, ``conv2.bn1``, ``conv2.downsample.0``,
``m0.coordconv.conv``, ``m0.b1_4``, ``top_m_0``, ``conv_last0``,
``bn_end0``, ``l0``).

The network only runs frozen: BatchNorm is folded into one scale/shift
from its running statistics and applied in the compute dtype.  On CUDA
every DenseConvBlock with in = out features (15 of them at 256 input)
runs kernel 2 (:func:`ops.denseblock.fused_dense_block`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.denseblock import dense_block_supported, fused_dense_block, pack_dense_bn
from ..ops.fusedconv import conv3x3_avgpool2x
from ..ops.image import avg_pool_2x, resize_bilinear, upsample_nearest_2x
from ..ops.winograd import pack_conv3x3_weight
from .stargan import Conv

__all__ = [
    "NUM_LANDMARKS",
    "CoordConv",
    "FrozenBatchNorm",
    "DenseConvBlock",
    "HourGlass",
    "FAN",
    "preprocess_heatmaps",
    "get_heatmap",
]

NUM_LANDMARKS = 98


def _coord_channels(height: int, width: int, with_r: bool) -> np.ndarray:
    """(H, W, 2 or 3) coordinate maps with the reference's exact f32
    arithmetic (wing.py:86-99): 'x' varies along H."""
    x = (np.arange(height, dtype=np.float32) / np.float32(height - 1)) * np.float32(2) - np.float32(1)
    y = (np.arange(width, dtype=np.float32) / np.float32(width - 1)) * np.float32(2) - np.float32(1)
    x = x[:, None] * np.ones((1, width), np.float32)
    y = np.ones((height, 1), np.float32) * y[None]
    chans = [x, y]
    if with_r:
        rr = np.sqrt(x**2 + y**2)
        chans.append(rr / rr.max())
    return np.stack(chans, axis=-1)


@functools.lru_cache(maxsize=16)
def _coord_tensor(height: int, width: int, with_r: bool, device: str) -> torch.Tensor:
    """(1, 2 or 3, H, W) coordinate maps kept on ``device``."""
    c = _coord_channels(height, width, with_r)
    return torch.from_numpy(c).permute(2, 0, 1)[None].contiguous().to(device)


def _conv(x: torch.Tensor, w: torch.Tensor, dtype, stride=1, padding=0) -> torch.Tensor:
    return F.conv2d(x.to(dtype), w.to(dtype), None, stride, padding)


class FrozenBatchNorm(nn.BatchNorm2d):
    """BatchNorm2d evaluated from its running statistics, folded into
    one f32 (mul, add) pair and applied in the input's dtype."""

    def fold(self) -> tuple[torch.Tensor, torch.Tensor]:
        inv = torch.rsqrt(self.running_var + self.eps)
        mul = inv * self.weight
        add = self.bias - self.running_mean * inv * self.weight
        return mul, add

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul, add = self.fold()
        return x * mul.to(x.dtype)[:, None, None] + add.to(x.dtype)[:, None, None]


class CoordConv(nn.Module):
    """Conv over the input plus static coordinate channels.  The
    coordinate channels' contribution is a constant map, convolved
    separately and added, so the data conv never sees a channel concat
    (same math as convolving the concatenation, as in the JAX package).
    The boundary-gated channels of the reference's stacked FAN are not
    used by the single-stack network and are not ported."""

    def __init__(self, in_channels, features, kernel, stride=1, with_r=False, dtype=None):
        super().__init__()
        self.with_r = with_r
        self.compute_dtype = dtype
        self.conv = nn.Conv2d(
            in_channels + (3 if with_r else 2), features, kernel, stride, padding=kernel // 2
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2], x.shape[-1]
        coords = _coord_tensor(h, w, self.with_r, str(x.device))
        cx = x.shape[1]
        dt = self.compute_dtype or x.dtype
        wt = self.conv.weight
        st, pd = self.conv.stride, self.conv.padding
        y = _conv(x, wt[:, :cx], dt, st, pd)
        y = y + _conv(coords, wt[:, cx:], dt, st, pd)
        return y + self.conv.bias.to(dt)[:, None, None]


class DenseConvBlock(nn.Module):
    """BN-relu-conv cascade whose three outputs concatenate to
    ``features`` channels, plus the residual (wing.py:139-175).

    ``pool_output=True`` returns ``avg_pool_2x(block(x))`` with the pool
    commuted through the concat and the residual 1x1, and the last conv
    fused with the pool into one 4x4/s2 conv (identical math)."""

    def __init__(self, in_features, features, pool_output=False, dtype=None):
        super().__init__()
        half, quarter = features // 2, features // 4
        self.in_features = in_features
        self.features = features
        self.pool_output = pool_output
        self.compute_dtype = dtype
        self.bn1 = FrozenBatchNorm(in_features)
        self.conv1 = nn.Conv2d(in_features, half, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm(half)
        self.conv2 = nn.Conv2d(half, quarter, 3, 1, 1, bias=False)
        self.bn3 = FrozenBatchNorm(quarter)
        self.conv3 = nn.Conv2d(quarter, quarter, 3, 1, 1, bias=False)
        if in_features != features:
            self.downsample = nn.Sequential(
                FrozenBatchNorm(in_features),
                nn.ReLU(),
                Conv(in_features, features, 1, bias=False, dtype=dtype),
            )
        self._args_key = None
        self._args = None

    def _kernel_args(self, dtype, packed: bool) -> tuple[torch.Tensor, ...]:
        """What ``fused_dense_block`` takes after x, made once per version
        of the weights and BN entries: the three kernels in the compute
        dtype (packed by ``pack_conv3x3_weight`` for the CUDA kernel, HWIO
        for the CPU's plain version) and the (6, F) BN pack."""
        bns = (self.bn1, self.bn2, self.bn3)
        ws = (self.conv1.weight, self.conv2.weight, self.conv3.weight)
        ts = ws + tuple(t for bn in bns for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var))
        key = tuple((t._version, t.data_ptr()) for t in ts) + (dtype, packed)
        if key != self._args_key:
            with torch.no_grad():
                ks = [w.permute(2, 3, 1, 0).to(dtype).contiguous() for w in ws]
                if packed:
                    ks = [pack_conv3x3_weight(k) for k in ks]
                self._args = (*ks, pack_dense_bn([bn.fold() for bn in bns], self.features))
            self._args_key = key
        return self._args

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or x.dtype
        xn = x.permute(0, 2, 3, 1)
        if (
            not self.pool_output
            and self.in_features == self.features
            and x.dtype == dt
            and (x.device.type != "cuda" or dense_block_supported(xn))
        ):
            # Whole block in one kernel call on CUDA; its plain op chain on CPU.
            out = fused_dense_block(xn, *self._kernel_args(dt, x.device.type == "cuda"))
            return out.permute(0, 3, 1, 2)

        o1 = _conv(torch.relu(self.bn1(x)), self.conv1.weight, dt, 1, 1)
        o2 = _conv(torch.relu(self.bn2(o1)), self.conv2.weight, dt, 1, 1)
        h3 = torch.relu(self.bn3(o2))
        if not self.pool_output:
            o3 = _conv(h3, self.conv3.weight, dt, 1, 1)
            out = torch.cat([o1, o2, o3], dim=1)
            res = x
            if self.in_features != self.features:
                bn, _, conv = self.downsample
                res = conv(torch.relu(bn(res)))
            return out + res
        o3p = conv3x3_avgpool2x(h3.to(dt), self.conv3.weight)
        out = torch.cat([avg_pool_2x(o1), avg_pool_2x(o2), o3p], dim=1)
        if self.in_features != self.features:
            # The 1x1 conv commutes with the mean pool: run it small.
            bn, _, conv = self.downsample
            res = conv(avg_pool_2x(torch.relu(bn(x)).to(dt)))
        else:
            res = avg_pool_2x(x)
        return out + res


class HourGlass(nn.Module):
    """Recursive encoder-decoder at depth 4 over 256-channel features;
    blocks named as the reference names them (b1_d, b2_d, b2_plus_1,
    b3_d)."""

    def __init__(self, depth=4, features=256, dtype=None):
        super().__init__()
        self.depth = depth
        self.coordconv = CoordConv(features, features, 1, with_r=True, dtype=dtype)
        for d in range(depth, 0, -1):
            for name in ("b1", "b2", "b3"):
                self.add_module(f"{name}_{d}", DenseConvBlock(features, features, dtype=dtype))
        self.add_module("b2_plus_1", DenseConvBlock(features, features, dtype=dtype))

    def _level(self, h: torch.Tensor, d: int) -> torch.Tensor:
        up1 = self._modules[f"b1_{d}"](h)
        low = self._modules[f"b2_{d}"](avg_pool_2x(h))
        low = self._level(low, d - 1) if d > 1 else self._modules["b2_plus_1"](low)
        low = self._modules[f"b3_{d}"](low)
        return up1 + upsample_nearest_2x(low)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._level(self.coordconv(x), self.depth)


class FAN(nn.Module):
    """Single-stack FAN: stem to 64x64x256, hourglass, 99-channel head.

    ``forward(x, fold_privacy_head=True)`` returns the two privacy masks
    at head resolution, (B, 2, 64, 64) f32: the masks are channel sums
    of the head output (wing.py:249-251), and a channel sum of 1x1-conv
    outputs is a 1x1 conv with the group-summed kernel and bias, summed
    in f32; the conv takes the bf16-rounded operands with f32
    accumulation and output."""

    def __init__(self, num_landmarks: int = NUM_LANDMARKS, dtype=None):
        super().__init__()
        self.num_landmarks = num_landmarks
        self.compute_dtype = dtype
        self.conv1 = CoordConv(3, 64, 7, stride=2, with_r=True, dtype=dtype)
        self.bn1 = FrozenBatchNorm(64)
        self.conv2 = DenseConvBlock(64, 128, pool_output=True, dtype=dtype)
        self.conv3 = DenseConvBlock(128, 128, dtype=dtype)
        self.conv4 = DenseConvBlock(128, 256, dtype=dtype)
        self.m0 = HourGlass(dtype=dtype)
        self.top_m_0 = DenseConvBlock(256, 256, dtype=dtype)
        self.conv_last0 = Conv(256, 256, 1, dtype=dtype)
        self.bn_end0 = FrozenBatchNorm(256)
        self.l0 = nn.Conv2d(256, num_landmarks + 1, 1)

    def forward(self, x: torch.Tensor, fold_privacy_head: bool = False) -> torch.Tensor:
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        x = torch.relu(self.bn1(self.conv1(x)))  # 256 -> 128
        x = self.conv2(x)  # pooled: 128 -> 64
        x = self.conv3(x)
        x = self.conv4(x)
        h = self.m0(x)
        h = self.top_m_0(h)
        h = torch.relu(self.bn_end0(self.conv_last0(h)))
        dt = self.compute_dtype or h.dtype
        kern, bias = self.l0.weight, self.l0.bias
        if fold_privacy_head:
            kf = torch.stack([kern[:49].sum(0), kern[49:98].sum(0)])
            bf = torch.stack([bias[:49].sum(), bias[49:98].sum()])
            acc = torch.promote_types(h.dtype, torch.float32)
            out = F.conv2d(h.to(acc), kf.to(dt).to(acc))
            return out + bf.to(acc)[:, None, None]
        return _conv(h, kern, dt) + bias.to(dt)[:, None, None]


# ---------------------------------------------------------------------------
# Heatmap post-processing (NHWC, as the JAX package's public API).
# ---------------------------------------------------------------------------

# Facial-part channel ranges (reference wing.py:518-528).
IDX = dict(
    chin=(8, 25),
    eyebrows=(33, 51),
    eyebrowsedges=(33, 46),
    nose=(51, 55),
    nostrils=(55, 60),
    eyes=(60, 76),
    lipedges=(76, 82),
    lipupper=(77, 82),
    liplower=(83, 88),
    lipinner=(88, 96),
)


def _roll_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """The reference's ``shift`` (wing.py:497-515): a circular row roll."""
    return torch.roll(x, -n, dims=-3)


def preprocess_heatmaps(hm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Facial-part shift/sharpen pipeline (wing.py:532-578) on an NHWC
    (B, H, W, 98) heatmap -> two (B, H, W, 1) masks in [0, 1]."""
    h = hm.shape[-3]
    sw = h // 256
    ops = dict(
        chin=(0, 3),
        eyebrows=(-7 * sw, 2),
        nostrils=(8 * sw, 4),
        lipupper=(-8 * sw, 4),
        liplower=(8 * sw, 4),
        lipinner=(-2 * sw, 3),
    )
    x = hm.clone()
    for part, (shift_n, power) in ops.items():
        s, e = IDX[part]
        x[..., s:e] = _roll_rows(x[..., s:e], shift_n) ** power
    zero = (
        list(range(0, IDX["chin"][0]))
        + list(range(IDX["chin"][1], 33))
        + [IDX["eyebrowsedges"][0], IDX["eyebrowsedges"][1], IDX["lipedges"][0], IDX["lipedges"][1]]
    )
    x[..., zero] = 0.0
    s, e = IDX["nose"]
    x[..., s + 1 : e] = _roll_rows(x[..., s + 1 : e], 4 * sw)
    s, e = IDX["eyes"]
    eyes = x[..., s:e].clone()
    x[..., s:e] = _roll_rows(eyes, -8) ** 3 + _roll_rows(eyes, -24)

    x2 = x.clone()
    x2[..., IDX["chin"][0] : IDX["chin"][1]] = 0.0
    x2[..., IDX["lipedges"][0] : IDX["lipinner"][1]] = 0.0
    x2[..., IDX["eyebrows"][0] : IDX["eyebrows"][1]] = 0.0
    m1 = torch.nan_to_num(torch.sum(x, dim=-1, keepdim=True))
    m2 = torch.nan_to_num(torch.sum(x2, dim=-1, keepdim=True))
    return torch.clamp(m1, 0.0, 1.0), torch.clamp(m2, 0.0, 1.0)


def get_heatmap(
    fan: FAN, x: torch.Tensor, privacy: bool = False, delimiter: bool = False, input_size: int = 256
) -> tuple[torch.Tensor, torch.Tensor]:
    """0-1 heatmap masks of an NHWC image batch (wing.py:241-260):
    resize to ``input_size`` (bilinear), ``x*0.5+0.5``, run the net,
    upsample with align_corners=True, then either the two privacy masks
    (clamped sums of channels [0:49) and [49:98)) or the preprocess
    pipeline.  Returns two NHWC (B, s, s, 1) masks."""
    s = input_size
    dt = fan.compute_dtype or x.dtype
    xr = resize_bilinear(x.to(dt).permute(0, 3, 1, 2), (s, s))
    if privacy:
        # The channel sums commute with the bilinear resize, so they run
        # at head resolution, folded into the head conv.
        m = fan(xr * 0.5 + 0.5, fold_privacy_head=True)
        m = resize_bilinear(m, (s, s), align_corners=True).permute(0, 2, 3, 1)
        return torch.clamp(m[..., :1], 0.0, 1.0), torch.clamp(m[..., 1:], 0.0, 1.0)
    out = fan(xr * 0.5 + 0.5)
    hm = out[:, :NUM_LANDMARKS]
    hm = resize_bilinear(hm.to(torch.promote_types(hm.dtype, torch.float32)), (s, s), align_corners=True)
    hm = hm.permute(0, 2, 3, 1).clone()
    if delimiter:
        hm[..., :33] = 0.0
    return preprocess_heatmaps(hm)
