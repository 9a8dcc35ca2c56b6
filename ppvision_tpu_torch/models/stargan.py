"""StarGAN-v2 de-identification networks (PyTorch, NCHW channels_last).

Port of ``ppvision_tpu/models/stargan.py`` (reference
``core/model.py``): Generator with its ``encode``/``decode`` split,
MappingNetwork and StyleEncoder.  Modules keep the reference
state_dict names (``from_rgb``, ``encode.N.conv1``,
``decode.N.norm1.fc``, ``to_rgb.2``, ``shared.N``, ``unshared.N``,
``main.N``) so reference checkpoints load directly.  The Discriminator
runs in training only.

Numerics follow the JAX package op for op: parameters stay f32 and are
cast to the compute dtype at use; convs and dense layers round their
output to the compute dtype before the bias add; InstanceNorm takes f32
moments and casts back; AdaIN's gamma/beta and the residual scaling run
in the compute dtype, with Python scalars rounded to it first as JAX's
weak types do.  Two kernels sit under these modules on CUDA: every
stride-1 3x3 conv with channels % 16 = 0 in bf16 runs
:func:`ops.winograd.conv3x3`, and every InstanceNorm/AdaIN moment and
the encoder's skip mean run :func:`ops.instats.instance_moments`.
Both carry gradients: their backward is the plain version's VJP, and
conv3x3's is differentiable again (R1's gradient of a gradient).

``Generator(quant_decode=True)`` runs the decoder's 3x3 convs and
nearest-up2x convs in int8 (``ops/quant.py``), the opt-in lossy serving
mode of ``ppvision_tpu/models/stargan.py::_QuantConv`` and
``_ResampleConv3x3(quant=True)``, over the same state_dict; the decoder's
1x1 shortcut and ``to_rgb`` stay exact.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fusedconv import conv3x3_avgpool2x, conv3x3_nearest_up2x
from ..ops.image import avg_pool_2x, resize_bilinear, upsample_nearest_2x
from ..ops.instats import instance_moments
from ..ops.quant import int8_conv, int8_conv3x3_nearest_up2x, quantize_up2x_weight, quantize_weight_per_oc
from ..ops.winograd import conv3x3, conv3x3_supported, pack_conv3x3_weight
from ..parallel.mesh import all_reduce_mean

__all__ = [
    "Conv",
    "InstanceNorm",
    "ResBlk",
    "AdaIN",
    "AdainResBlk",
    "highpass",
    "leaky_relu",
    "Generator",
    "MappingNetwork",
    "StyleEncoder",
    "Discriminator",
    "build_gan_models",
    "init_params_",
]


@functools.lru_cache(maxsize=32)
def _weak(v: float, dtype: torch.dtype) -> float:
    """A Python scalar rounded to ``dtype`` first, as JAX rounds a weak
    type to its operand's dtype; the op then computes with that value."""
    return float(torch.tensor(v, dtype=dtype))


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """``jax.nn.leaky_relu``: the slope is rounded to x's dtype."""
    return F.leaky_relu(x, _weak(slope, x.dtype))


def _res_scale(s: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``((s + r) / sqrt(2)).astype(r.dtype)`` with a weak-typed sqrt(2)."""
    t = s + r
    return (t / _weak(math.sqrt(2), t.dtype)).to(r.dtype)


def _dense(x: torch.Tensor, lin: nn.Linear, dtype) -> torch.Tensor:
    """Flax ``nn.Dense(dtype=...)``: matmul rounded, then the bias add."""
    dt = dtype or x.dtype
    return F.linear(x.to(dt), lin.weight.to(dt)) + lin.bias.to(dt)


def _moments_nchw(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 (B, C) moments of an NCHW tensor via the NHWC kernel view."""
    return instance_moments(x.permute(0, 2, 3, 1))


class Conv(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype`` like the JAX
    package's ``Conv``: the conv output is rounded to the compute dtype,
    then the bias is added in it.  Stride-1 SAME 3x3 convs on CUDA bf16
    with channels % 16 = 0 run kernel 4; the kernel's (3, 3, C, K) bf16
    weight copy and its packed image (``pack_conv3x3_weight``) are made
    once per weight version, so an optimizer step repacks them.  Where
    the weight takes a gradient the kernel is handed the differentiable
    compute-dtype weight beside the packed copy."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0, bias=True, dtype=None):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding, bias=bias)
        self.compute_dtype = dtype
        self._hwio_key = None
        self._hwio = None
        self._packed = None
        self._quant_key = None
        self._quant = None

    def hwio_weight(self, dtype) -> torch.Tensor:
        key = (self.weight._version, self.weight.data_ptr(), dtype)
        if key != self._hwio_key:
            self._hwio = self.weight.detach().permute(2, 3, 1, 0).to(dtype).contiguous()
            self._packed = None
            self._hwio_key = key
        return self._hwio

    def packed_weight(self, dtype) -> torch.Tensor:
        """The kernel's weight: the HWIO copy packed, cached beside it."""
        hwio = self.hwio_weight(dtype)
        if self._packed is None:
            self._packed = pack_conv3x3_weight(hwio)
        return self._packed

    def quantized_weight(self, up: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """The int8 decode's (int8 HWIO kernel, per-output-channel scale)
        of this 3x3 conv, or with ``up`` of its nearest-up2x 4x4 kernel;
        made once per weight version."""
        key = (self.weight._version, self.weight.data_ptr(), up)
        if key != self._quant_key:
            hwio = self.weight.detach().permute(2, 3, 1, 0)
            self._quant = quantize_up2x_weight(hwio) if up else quantize_weight_per_oc(hwio)
            self._quant_key = key
        return self._quant

    def _kernel_eligible(self, x: torch.Tensor) -> bool:
        return (
            x.device.type == "cuda"
            and self.kernel_size == (3, 3)
            and self.stride == (1, 1)
            and self.padding == (1, 1)
            and conv3x3_supported(x.permute(0, 2, 3, 1), self.out_channels)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or x.dtype
        x = x.to(dt)
        if self._kernel_eligible(x):
            if torch.is_grad_enabled() and self.weight.requires_grad:
                w = self.weight.permute(2, 3, 1, 0).to(dt)
            else:
                w = self.hwio_weight(dt)
            y = conv3x3(x.permute(0, 2, 3, 1), w, self.packed_weight(dt)).permute(0, 3, 1, 2)
        else:
            y = F.conv2d(x, self.weight.to(dt), None, self.stride, self.padding)
        if self.bias is not None:
            y = y + self.bias.to(dt)[:, None, None]
        return y


def _resample_conv(x: torch.Tensor, conv: Conv, mode: str) -> torch.Tensor:
    """3x3 conv fused with its adjacent 2x resample (ops/fusedconv),
    from the conv's f32 master weight; bias added after."""
    dt = conv.compute_dtype or x.dtype
    x = x.to(dt)
    fn = conv3x3_nearest_up2x if mode == "up" else conv3x3_avgpool2x
    y = fn(x, conv.weight)
    return y + conv.bias.to(y.dtype)[:, None, None]


def _quant_conv(x: torch.Tensor, conv: Conv, up: bool = False) -> torch.Tensor:
    """Int8 stand-in of a stride-1 SAME 3x3 conv or, with ``up``, of the
    nearest-up2x conv (ops/quant.py) on the conv's own weights; bias
    added after in the compute dtype."""
    dt = conv.compute_dtype or x.dtype
    fn = int8_conv3x3_nearest_up2x if up else int8_conv
    y = fn(x.to(dt).permute(0, 2, 3, 1), conv.weight.permute(2, 3, 1, 0), conv.quantized_weight(up))
    y = y.permute(0, 3, 1, 2)
    return y + conv.bias.to(y.dtype)[:, None, None]


class InstanceNorm(nn.InstanceNorm2d):
    """Per-sample per-channel normalization over H, W with f32
    statistics in the two-moment form (E[x], E[x^2]) and a biased
    variance, as the JAX package and torch's InstanceNorm2d compute."""

    def __init__(self, num_features: int, affine: bool = True, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, affine=affine)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, m2 = _moments_nchw(x)
        mean, m2 = mean[:, :, None, None], m2[:, :, None, None]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        var = torch.clamp_min(m2 - mean * mean, 0.0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        if self.affine:
            y = y * self.weight[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


class ResBlk(nn.Module):
    """Pre-activation residual block with optional IN and 2x downsample
    (reference model.py:16-55)."""

    def __init__(self, dim_in, dim_out, normalize=False, downsample=False, dtype=None):
        super().__init__()
        self.normalize = normalize
        self.downsample = downsample
        self.learned_sc = dim_in != dim_out
        self.conv1 = Conv(dim_in, dim_in, 3, 1, 1, dtype=dtype)
        self.conv2 = Conv(dim_in, dim_out, 3, 1, 1, dtype=dtype)
        if normalize:
            self.norm1 = InstanceNorm(dim_in)
            self.norm2 = InstanceNorm(dim_in)
        if self.learned_sc:
            self.conv1x1 = Conv(dim_in, dim_out, 1, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Shortcut: a 1x1 conv commutes with the mean pool, so pool first.
        s = x
        if self.downsample:
            s = avg_pool_2x(s)
        if self.learned_sc:
            s = self.conv1x1(s)
        r = x
        if self.normalize:
            r = self.norm1(r)
        r = leaky_relu(r)
        r = _resample_conv(r, self.conv1, "down") if self.downsample else self.conv1(r)
        if self.normalize:
            r = self.norm2(r)
        r = leaky_relu(r)
        r = self.conv2(r)
        return _res_scale(s, r)


class AdaIN(nn.Module):
    """Style-modulated instance norm: (1 + gamma) * IN(x) + beta, with
    gamma/beta from a dense layer in the compute dtype."""

    def __init__(self, style_dim: int, num_features: int, dtype=None):
        super().__init__()
        self.compute_dtype = dtype
        self.norm = InstanceNorm(num_features, affine=False)
        self.fc = nn.Linear(style_dim, num_features * 2)

    def forward(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        h = _dense(s, self.fc, self.compute_dtype)
        gamma, beta = torch.chunk(h, 2, dim=1)
        y = self.norm(x)
        out = (1 + gamma[:, :, None, None]) * y + beta[:, :, None, None]
        return out.to(x.dtype)


class AdainResBlk(nn.Module):
    """Style-modulated residual block with optional 2x nearest upsample;
    with ``w_hpf != 0`` the output is the residual branch alone
    (reference model.py:105-109).  ``quant`` runs its two 3x3 convs (the
    first fused with the upsample) in int8."""

    def __init__(self, dim_in, dim_out, style_dim=64, w_hpf=0.0, upsample=False, dtype=None, quant=False):
        super().__init__()
        self.w_hpf = w_hpf
        self.upsample = upsample
        self.quant = quant
        self.learned_sc = dim_in != dim_out
        self.conv1 = Conv(dim_in, dim_out, 3, 1, 1, dtype=dtype)
        self.conv2 = Conv(dim_out, dim_out, 3, 1, 1, dtype=dtype)
        self.norm1 = AdaIN(style_dim, dim_in, dtype=dtype)
        self.norm2 = AdaIN(style_dim, dim_out, dtype=dtype)
        if w_hpf == 0 and self.learned_sc:
            self.conv1x1 = Conv(dim_in, dim_out, 1, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        r = leaky_relu(self.norm1(x, s))
        if self.quant:
            r = _quant_conv(r, self.conv1, up=self.upsample)
        else:
            r = _resample_conv(r, self.conv1, "up") if self.upsample else self.conv1(r)
        r = leaky_relu(self.norm2(r, s))
        r = _quant_conv(r, self.conv2) if self.quant else self.conv2(r)
        if self.w_hpf == 0:
            sc = x
            if self.learned_sc:
                sc = self.conv1x1(sc)
            if self.upsample:
                sc = upsample_nearest_2x(sc)
            r = _res_scale(r, sc)
        return r


@functools.lru_cache(maxsize=16)
def _highpass_kernel(w_hpf: float, dtype: torch.dtype, device: str) -> torch.Tensor:
    k = np.array([[-1, -1, -1], [-1, 8.0, -1], [-1, -1, -1]], dtype=np.float32) / w_hpf
    return torch.from_numpy(k).to(device=device, dtype=dtype)[None, None]


def highpass(x: torch.Tensor, w_hpf: float) -> torch.Tensor:
    """Depthwise 3x3 Laplacian sharpening filter (reference
    model.py:112-122)."""
    c = x.shape[1]
    w = _highpass_kernel(float(w_hpf), x.dtype, str(x.device)).expand(c, 1, 3, 3)
    return F.conv2d(x, w, padding=1, groups=c)


def _channel_dims(img_size: int, max_conv_dim: int, num_blocks: int) -> list[int]:
    dims = [2**14 // img_size]
    for _ in range(num_blocks):
        dims.append(min(dims[-1] * 2, max_conv_dim))
    return dims


class Generator(nn.Module):
    """Encoder/decoder with style-modulated decoding and heatmap-guided
    high-pass skips at 32/64/128 feature resolutions, split into
    ``encode`` (style-independent) and ``decode`` (per style).
    ``quant_decode`` runs the decoder's 3x3 convs in int8 (the opt-in
    lossy serving mode; the same state_dict)."""

    def __init__(self, img_size=256, style_dim=64, max_conv_dim=512, w_hpf=1.0, dtype=None, quant_decode=False):
        super().__init__()
        self.w_hpf = w_hpf
        self.compute_dtype = dtype
        rn = int(math.log2(img_size)) - 4 + (1 if w_hpf > 0 else 0)
        self.repeat_num = rn
        dims = _channel_dims(img_size, max_conv_dim, rn)
        self.from_rgb = Conv(3, dims[0], 3, 1, 1, dtype=dtype)
        enc = [ResBlk(dims[i], dims[i + 1], normalize=True, downsample=True, dtype=dtype) for i in range(rn)]
        enc += [ResBlk(dims[-1], dims[-1], normalize=True, dtype=dtype) for _ in range(2)]
        # The reference names the block lists ``encode``/``decode``; the
        # same names are this class's methods, so the lists are
        # registered under those names and read through ``_modules``.
        self._modules["encode"] = nn.ModuleList(enc)
        q = quant_decode
        dec = [AdainResBlk(dims[-1], dims[-1], style_dim, w_hpf, dtype=dtype, quant=q) for _ in range(2)]
        dec += [
            AdainResBlk(dims[i + 1], dims[i], style_dim, w_hpf, upsample=True, dtype=dtype, quant=q)
            for i in reversed(range(rn))
        ]
        self._modules["decode"] = nn.ModuleList(dec)
        self.to_rgb = nn.Sequential(
            InstanceNorm(dims[0]), nn.LeakyReLU(0.2), nn.Conv2d(dims[0], 3, 1)
        )

    def encode(self, x: torch.Tensor, masks=None):
        """Style-independent half: NCHW x -> (bottleneck z, ((size, hp), ...))."""
        rn = self.repeat_num
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x = self.from_rgb(x)
        cache = []
        for i in range(rn):
            if masks is not None and x.shape[-2] in (32, 64, 128):
                # The reference caches x - x.mean() over the whole batch
                # (model.py:175): one scalar, the mean of the per-(b, c)
                # spatial means; under a mesh, over the global batch
                # (the ranks' local batches are equal).
                m = all_reduce_mean(_moments_nchw(x)[0].mean())
                cache.append((x.shape[-2], x, m))
            x = self._modules["encode"][i](x)
        for j in range(2):
            x = self._modules["encode"][rn + j](x)
        hps = []
        for size, feat, m in cache:
            mask = masks[0] if size == 32 else masks[1]
            mask = resize_bilinear(mask, (size, size)).to(feat.dtype)
            # HP(mask * (x - m)) = HP(mask * x) - m * HP(mask): the
            # centered tensor is never materialized.
            hp = highpass(mask * feat, self.w_hpf) - m.to(feat.dtype) * highpass(mask, self.w_hpf)
            hps.append((size, hp))
        return x, tuple(hps)

    def decode(self, z: torch.Tensor, s: torch.Tensor, hps=()):
        """Style-modulated half -> NCHW image in f32 (f64 for f64)."""
        x = z if self.compute_dtype is None else z.to(self.compute_dtype)
        if self.compute_dtype is not None:
            s = s.to(self.compute_dtype)
        hp_by_size = dict(hps)
        for blk in self._modules["decode"]:
            x = blk(x, s)
            hp = hp_by_size.get(x.shape[-2]) if blk.upsample else None
            if hp is not None:
                if x.shape[0] != hp.shape[0]:
                    hp = hp.repeat(x.shape[0] // hp.shape[0], 1, 1, 1)
                x = x + hp
        norm, _, conv = self.to_rgb
        x = leaky_relu(norm(x))
        y = F.conv2d(x, conv.weight.to(x.dtype)) + conv.bias.to(x.dtype)[:, None, None]
        return y.to(torch.promote_types(y.dtype, torch.float32))

    def forward(self, x: torch.Tensor, s: torch.Tensor, masks=None) -> torch.Tensor:
        """Anonymize NCHW ``x`` with styles ``s`` ((R*B, style_dim), R
        contiguous blocks of B): encode once, decode at R*B."""
        b0 = x.shape[0]
        if s.shape[0] % b0 != 0:
            raise ValueError(f"style batch {s.shape[0]} must be a multiple of image batch {b0}")
        z, hps = self.encode(x, masks)
        reps = s.shape[0] // b0
        if reps > 1:
            # Repeated in NHWC: z stays channels_last, so the first norm's
            # moments kernel reads it without a copy.
            z = z.permute(0, 2, 3, 1).repeat(reps, 1, 1, 1).permute(0, 3, 1, 2)
        return self.decode(z, s, hps)


def _select_domain(out: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Each sample's domain head: out[b, y[b]]."""
    return out[torch.arange(out.shape[0], device=out.device), y.to(out.device)]


class MappingNetwork(nn.Module):
    """Latent z -> per-domain style codes through an 8-layer MLP tree."""

    def __init__(self, latent_dim=16, style_dim=64, num_domains=2, dtype=None):
        super().__init__()
        self.compute_dtype = dtype
        layers = [nn.Linear(latent_dim, 512), nn.ReLU()]
        for _ in range(3):
            layers += [nn.Linear(512, 512), nn.ReLU()]
        self.shared = nn.Sequential(*layers)
        self.unshared = nn.ModuleList()
        for _ in range(num_domains):
            head = []
            for _ in range(3):
                head += [nn.Linear(512, 512), nn.ReLU()]
            self.unshared.append(nn.Sequential(*head, nn.Linear(512, style_dim)))

    def forward(self, z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        h = z if dt is None else z.to(dt)
        for lin in self.shared[0::2]:
            h = torch.relu(_dense(h, lin, dt))
        outs = []
        for head in self.unshared:
            u = h
            for lin in head[0:6:2]:
                u = torch.relu(_dense(u, lin, dt))
            outs.append(_dense(u, head[6], dt))
        out = _select_domain(torch.stack(outs, dim=1), y)
        return out.to(torch.promote_types(out.dtype, torch.float32))


def _trunk(img_size: int, max_conv_dim: int, dtype) -> tuple[list[nn.Module], int]:
    """The conv trunk the StyleEncoder and the Discriminator share: stem,
    ResBlks down to 4x4, LReLU, 4x4 valid conv, LReLU; and its width."""
    repeat = int(math.log2(img_size)) - 2
    dims = _channel_dims(img_size, max_conv_dim, repeat)
    blocks = [Conv(3, dims[0], 3, 1, 1, dtype=dtype)]
    blocks += [ResBlk(dims[i], dims[i + 1], downsample=True, dtype=dtype) for i in range(repeat)]
    blocks += [nn.LeakyReLU(0.2), Conv(dims[-1], dims[-1], 4, 1, 0, dtype=dtype), nn.LeakyReLU(0.2)]
    return blocks, dims[-1]


def _run_trunk(blocks, x: torch.Tensor, dtype) -> torch.Tensor:
    """NCHW images through the trunk's blocks -> (B, width)."""
    h = x if dtype is None else x.to(dtype)
    for m in blocks:
        h = leaky_relu(h) if isinstance(m, nn.LeakyReLU) else m(h)
    return h.reshape(h.shape[0], -1)


class StyleEncoder(nn.Module):
    """Image -> per-domain style code: the conv trunk, one dense head per
    domain."""

    def __init__(self, img_size=256, style_dim=64, num_domains=2, max_conv_dim=512, dtype=None):
        super().__init__()
        self.compute_dtype = dtype
        blocks, width = _trunk(img_size, max_conv_dim, dtype)
        self.shared = nn.Sequential(*blocks)
        self.unshared = nn.ModuleList(nn.Linear(width, style_dim) for _ in range(num_domains))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """NCHW images, integer domains -> (B, style_dim) f32 styles."""
        h = _run_trunk(self.shared, x, self.compute_dtype)
        out = torch.stack([_dense(h, lin, self.compute_dtype) for lin in self.unshared], dim=1)
        out = _select_domain(out, y)
        return out.to(torch.promote_types(out.dtype, torch.float32))


class Discriminator(nn.Module):
    """Image -> real/fake logit of its domain (reference model.py:253-277):
    the conv trunk and a 1x1 conv to one logit per domain, all under
    ``main``.  The 1x1 conv sees a 1x1 map, so it runs as the JAX
    package's dense layer: matmul rounded to the compute dtype, then the
    bias."""

    def __init__(self, img_size=256, num_domains=2, max_conv_dim=512, dtype=None):
        super().__init__()
        self.compute_dtype = dtype
        blocks, width = _trunk(img_size, max_conv_dim, dtype)
        self.main = nn.Sequential(*blocks, nn.Conv2d(width, num_domains, 1))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """NCHW images, integer domains -> (B,) f32 logits."""
        h = _run_trunk(self.main[:-1], x, self.compute_dtype)
        head = self.main[-1]
        dt = self.compute_dtype or h.dtype
        out = F.linear(h.to(dt), head.weight.flatten(1).to(dt)) + head.bias.to(dt)
        out = _select_domain(out, y)
        return out.to(torch.promote_types(out.dtype, torch.float32))


@torch.no_grad()
def init_params_(module: nn.Module, seed: int, gain: float = 2.0) -> nn.Module:
    """Seeded in-place init: conv/linear weights ~ N(0, gain / fan_in)
    (``gain=2`` is the reference's he_init, core/utils.py:37-45; 1 is
    LeCun), biases zero; norm layers keep their unit/zero defaults."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=g) * math.sqrt(gain / fan_in)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
    return module


def build_gan_models(
    img_size: int = 256,
    style_dim: int = 64,
    latent_dim: int = 16,
    num_domains: int = 2,
    w_hpf: float = 1.0,
    max_conv_dim: int = 512,
    dtype=None,
    quant_decode: bool = False,
) -> dict[str, nn.Module]:
    """The four GAN nets (reference build_model, model.py:280-310); the
    discriminator runs in training only.  ``quant_decode`` switches the
    generator's decoder to the opt-in int8 serving mode (ops/quant.py);
    the state_dicts are unchanged."""
    return dict(
        generator=Generator(img_size, style_dim, max_conv_dim, w_hpf, dtype=dtype, quant_decode=quant_decode),
        mapping_network=MappingNetwork(latent_dim, style_dim, num_domains, dtype=dtype),
        style_encoder=StyleEncoder(img_size, style_dim, num_domains, max_conv_dim, dtype=dtype),
        discriminator=Discriminator(img_size, num_domains, max_conv_dim, dtype=dtype),
    )
