"""ResNet-101 encoder of the privacy-preserving captioner.

Port of ``ppvision_tpu/models/resnet.py`` (reference ``Encoder``,
``Image_Caption/models.py:8-54``): a torchvision-style ResNet-101 without
its classifier, followed by an exact adaptive average pool to
``encoded_image_size`` (36) written as two averaging matmuls with torch
``AdaptiveAvgPool2d``'s bins.  The modules carry torchvision's
state_dict names (``conv1``, ``bn1``, ``layerN.i.convj/bnj``,
``layerN.0.downsample.0/1``).  Images go in NHWC, the trunk runs NCHW in
channels-last memory, and the features come out NHWC in f32.

BatchNorm keeps the JAX package's Flax ``BatchNorm`` (momentum 0.9, eps
1e-5) where it differs from ``torch.nn.BatchNorm2d``: the running
variance takes the *biased* batch variance.  The normalization itself is
``F.batch_norm`` (one fused pass forward and backward, statistics
accumulated in f32 under a bf16 compute dtype), which reports the batch
mean and unbiased variance into buffers of its own; the biased variance
is that times (n - 1) / n.  Flax computes the variance as
``E[x^2] - E[x]^2`` clipped at 0; the two agree to rounding.  A
train-mode forward leaves its batch statistics pending on each BN;
:func:`commit_batch_stats` folds them into the running buffers once, so
a forward recomputed under ``torch.utils.checkpoint`` does not update
them twice.

Under a mesh of more than one rank a train-mode BN normalizes by the
global batch's statistics, as a Flax BN does over a batch-sharded
array, and the pending statistics are the global ones
(:class:`_SyncedBatchNorm`): each rank's per-channel mean and biased
variance, in f32 or wider, are gathered and combined, ``F.batch_norm``
normalizes with them in its inference form, and the backward is one
fused reduction, one ``all_reduce_sum`` of the per-channel sums of dy
and dy * x_hat, and one elementwise pass.  (``torch.nn.SyncBatchNorm``
and the fused kernels behind it refuse CPU tensors.)
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import all_gather, all_reduce_sum, current_mesh

__all__ = ["BatchNorm", "Bottleneck", "CaptionEncoder", "ResNetBackbone", "adaptive_avg_pool",
           "commit_batch_stats", "init_encoder_"]

_MOMENTUM = 0.9  # Flax's convention: running = 0.9 * running + (1 - 0.9) * batch


@functools.lru_cache(maxsize=32)
def _adaptive_pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) row-averaging matrix with torch AdaptiveAvgPool2d bins:
    bin i covers [floor(i*in/out), ceil((i+1)*in/out))."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        a = (i * in_size) // out_size
        b = -((-(i + 1) * in_size) // out_size)  # ceil
        w[i, a:b] = 1.0 / (b - a)
    return w


def adaptive_avg_pool(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Exact torch adaptive average pool of an NHWC tensor via matmuls."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    wr = torch.from_numpy(_adaptive_pool_matrix(h, oh)).to(x.device, x.dtype)
    wc = torch.from_numpy(_adaptive_pool_matrix(w, ow)).to(x.device, x.dtype)
    x = torch.einsum("oh,bhwc->bowc", wr, x)
    return torch.einsum("ow,bhwc->bhoc", wc, x)


class Conv2d(nn.Conv2d):
    """Bias-free conv whose f32 weight is cast to the input's dtype at each
    use, as Flax's ``nn.Conv(dtype=...)`` casts its kernel."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride, self.padding)


class BatchNorm(nn.BatchNorm2d):
    """Flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` under torchvision's
    state_dict names (module docstring)."""

    def __init__(self, c: int):
        super().__init__(c, eps=1e-5)
        self.pending: tuple[torch.Tensor, torch.Tensor] | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
        mesh = current_mesh()
        if mesh is not None and mesh.world > 1:
            y, mean, var = _SyncedBatchNorm.apply(x, self.weight, self.bias, self.eps, mesh)
            self.pending = (mean.to(self.running_mean.dtype), var.to(self.running_var.dtype))
            return y
        # momentum 1 writes the batch mean and unbiased variance into the
        # fresh buffers, leaving the running ones to commit_batch_stats.
        mean, var = torch.zeros_like(self.running_mean), torch.ones_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        self.pending = (mean, var * ((n - 1) / n))
        return y


class _SyncedBatchNorm(torch.autograd.Function):
    """Train-mode BN of a rank's block over the mesh's global batch; the
    ranks' blocks are of one size.  Returns the output and the global
    mean and biased variance."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, mesh):
        var, mean = torch.var_mean(x.to(torch.promote_types(x.dtype, torch.float32)), dim=(0, 2, 3), correction=0)
        # The global variance: the mean of the ranks' variances plus the
        # variance of their means (exact for equal blocks).
        stats = all_gather(torch.stack([mean, var])[None], mesh=mesh)
        mean = stats[:, 0].mean(0)
        var = stats[:, 1].mean(0) + (stats[:, 0] - mean).square().mean(0)
        ctx.save_for_backward(x, weight, mean, var)
        ctx.eps, ctx.mesh, ctx.n = eps, mesh, x.numel() // x.shape[1] * mesh.world
        ctx.mark_non_differentiable(mean, var)
        return F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps), mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean, var = ctx.saved_tensors
        # The local sums of dy * x_hat and dy, the weight's and the bias's
        # gradients; their global means give
        # dx = w / sigma * (dy - mean(dy) - x_hat * mean(dy * x_hat)),
        # affine in dy and x channel by channel.
        invstd = torch.rsqrt(var + ctx.eps)
        _, gw, gb = torch.ops.aten.native_batch_norm_backward(dy, x, weight, mean, var, mean, invstd, True, ctx.eps,
                                                              [False, True, True])
        g_mean, gx_mean = all_reduce_sum(torch.stack([gb, gw]).to(mean.dtype), ctx.mesh) / ctx.n
        a = weight.to(mean.dtype) * invstd
        b = -a * invstd * gx_mean
        c = -a * g_mean - b * mean
        dx = torch.empty_like(x, dtype=mean.dtype)  # x's memory format
        torch.addcmul(c[:, None, None], dy, a[:, None, None], out=dx).addcmul_(x, b[:, None, None])
        return dx.to(x.dtype), gw.to(weight.dtype), gb.to(weight.dtype), None, None


def commit_batch_stats(module: nn.Module) -> None:
    """Fold every BN's pending batch statistics into its running mean and
    variance (Flax's update), and clear them."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm) and m.pending is not None:
                mean, var = m.pending
                m.running_mean.copy_(_MOMENTUM * m.running_mean + (1 - _MOMENTUM) * mean)
                m.running_var.copy_(_MOMENTUM * m.running_var + (1 - _MOMENTUM) * var)
                m.num_batches_tracked += 1
                m.pending = None


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1(x4) bottleneck, BN after each conv
    (ResNet v1.5: the stride on the 3x3)."""

    def __init__(self, cin: int, mid: int, stride: int = 1, project: bool = False):
        super().__init__()
        out = mid * 4
        self.conv1 = Conv2d(cin, mid, 1, bias=False)
        self.bn1 = BatchNorm(mid)
        self.conv2 = Conv2d(mid, mid, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm(mid)
        self.conv3 = Conv2d(mid, out, 1, bias=False)
        self.bn3 = BatchNorm(out)
        self.downsample = (
            nn.Sequential(Conv2d(cin, out, 1, stride=stride, bias=False), BatchNorm(out)) if project else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + residual)


class ResNetBackbone(nn.Module):
    """ResNet-v1.5 trunk without the classifier (output stride 32).

    ``dtype`` is the compute dtype (bf16 on the card); None computes in
    the promotion of the input's and the parameters' dtypes."""

    def __init__(self, stage_sizes: tuple[int, ...] = (3, 4, 23, 3), dtype: torch.dtype | None = None):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        cin, mid = 64, 64
        for stage, blocks in enumerate(self.stage_sizes):
            layer = []
            for b in range(blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                layer.append(Bottleneck(cin, mid, stride=stride, project=(b == 0)))
                cin = mid * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))
            mid *= 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> (B, H/32, W/32, 2048) NHWC features."""
        dtype = self.dtype or torch.promote_types(x.dtype, self.conv1.weight.dtype)
        x = x.to(dtype).permute(0, 3, 1, 2)  # NCHW view of channels-last memory
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in range(len(self.stage_sizes)):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x.permute(0, 2, 3, 1)


class CaptionEncoder(ResNetBackbone):
    """ResNet trunk + adaptive pool to (S, S, 2048), S = 36, returned in f32
    (reference Encoder, models.py:31-41).  The fine-tuning policy (stem
    and ``layer1`` frozen, models.py:43-54) is the trainer's, which zeroes
    their gradients."""

    def __init__(self, encoded_image_size: int = 36, stage_sizes: tuple[int, ...] = (3, 4, 23, 3),
                 dtype: torch.dtype | None = None):
        super().__init__(stage_sizes, dtype)
        self.encoded_image_size = encoded_image_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.encoded_image_size
        out = adaptive_avg_pool(super().forward(x), (s, s))
        return out.to(torch.promote_types(out.dtype, torch.float32))


def init_encoder_(encoder: nn.Module, seed: int) -> nn.Module:
    """torchvision's ResNet init from a seed: conv weights N(0, 2/fan_out),
    BN weight 1 and bias 0 (the running statistics 0 and 1)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in encoder.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                w = torch.randn(m.weight.shape, generator=g) * (2.0 / fan_out) ** 0.5
                m.weight.copy_(w)
            elif isinstance(m, BatchNorm):
                m.reset_parameters()
    return encoder
