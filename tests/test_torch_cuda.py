"""The port's kernels on the card, each against its plain PyTorch
version, the de-id path through its four kernels and RAFT through the
correlation kernel.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports torch, numpy and the port only (no JAX), so it also runs on a
machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import math

import numpy as np
import pytest
import torch

from ppvision_tpu_torch.ops.corr import _launch as _corr_launch
from ppvision_tpu_torch.ops.corr import local_corr, local_corr_ref, plan_corr
from ppvision_tpu_torch.ops.denseblock import dense_block_ref, fused_dense_block, pack_dense_bn
from ppvision_tpu_torch.ops.fftconv import fftconv_circular, fftconv_circular_ref
from ppvision_tpu_torch.ops.instats import _launch, _moments_ref, instance_moments, norm_apply, norm_apply_ref
from ppvision_tpu_torch.ops.winograd import conv3x3, conv3x3_ref, pack_conv3x3_weight

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev() -> torch.device:
    """The card, or a skip: decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the kernels run only on the card")
    return torch.device("cuda")


def _randn(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


# Every n the three passes treat apart (n = 4: one row block and one
# stage pair; n < Q = 16 columns; the paths' 128 and 256; Q bounded by
# the 64 KB column tile from 512; Q = 8 and channel groups at 1024), one
# to many channels, odd batches, and the video path's (16, 256, 256, 3).
@pytest.mark.parametrize(
    "b,n,c",
    [(2, 4, 3), (3, 8, 1), (1, 8, 4), (5, 64, 3), (8, 128, 3), (3, 128, 1), (2, 256, 4),
     (16, 256, 3), (1, 256, 13), (1, 512, 3), (1, 1024, 3), (1, 1024, 4)],
)
def test_fftconv_kernel_matches_plain(dev, b, n, c):
    rng = np.random.default_rng(0)
    img = _randn(rng, (b, n, n, c)).to(dev)
    otf = torch.fft.fft2(_randn(rng, (n, n, c)).to(dev), dim=(0, 1))
    args = (img, otf.real.contiguous(), otf.imag.contiguous())
    before = fftconv_circular.launches
    got = fftconv_circular(*args)
    assert fftconv_circular.launches == before + 1
    want = fftconv_circular_ref(*args)
    # f32 FFTs of O(1) data; relative to the output scale (sums of n^2 terms).
    assert float((got - want).abs().max()) <= 2e-5 * max(1.0, float(want.abs().max()))


def _dense_block_args(rng, dev, b, h, f):
    half, quarter = f // 2, f // 4
    x = _randn(rng, (b, h, h, f)).to(dev, torch.bfloat16)
    ks = [
        _randn(rng, s, 1 / math.sqrt(9 * s[2])).to(dev, torch.bfloat16)
        for s in ((3, 3, f, half), (3, 3, half, quarter), (3, 3, quarter, quarter))
    ]
    bns = [(1 + _randn(rng, (c,), 0.1).to(dev), _randn(rng, (c,), 0.1).to(dev)) for c in (f, half, quarter)]
    return x, ks, bns


# Every shape the two paths give the kernel (chip_smoke.DENSEBLOCK_SHAPES:
# FAN at the served batch of 8, which the interpolation video shares, and
# at the video's 16), the eval's aligned embed at a source batch's 80
# outputs (its largest and smallest), one image, and odd sizes whose
# tiles are ragged.
@pytest.mark.parametrize(
    "b,f,h",
    [(8, 128, 64), (8, 256, 64), (8, 256, 32), (8, 256, 16), (8, 256, 8), (8, 256, 4),
     (16, 128, 64), (16, 256, 64), (16, 256, 32), (16, 256, 16), (16, 256, 8), (16, 256, 4),
     (80, 128, 64), (80, 256, 4),
     (1, 256, 64), (1, 128, 5), (4, 128, 5), (2, 256, 7), (3, 128, 7)],
)
def test_dense_block_kernel_matches_plain(dev, b, f, h):
    x, ks, bns = _dense_block_args(np.random.default_rng(1), dev, b, h, f)
    before = fused_dense_block.launches
    got = fused_dense_block(x, *ks, *bns).float()
    assert fused_dense_block.launches == before + 1
    want = dense_block_ref(x, *ks, *bns).float()
    # bf16 convs, f32 sums in another order: direct-conv error scale.
    assert float((got - want).abs().max()) / float(want.abs().max()) < 2e-2


@pytest.mark.parametrize("f,h", [(256, 64), (128, 7)])
def test_dense_block_packed_and_repeated_calls_agree_bit_for_bit(dev, f, h):
    x, ks, bns = _dense_block_args(np.random.default_rng(2), dev, 8, h, f)
    packed = [pack_conv3x3_weight(k) for k in ks]
    bn = pack_dense_bn(bns, f)
    before = fused_dense_block.launches
    want = fused_dense_block(x, *ks, *bns)
    assert torch.equal(fused_dense_block(x, *packed, bn), want)
    assert torch.equal(fused_dense_block(x, *packed, bn), want)
    assert fused_dense_block.launches == before + 3


# The de-id path's seven shapes; the video path's largest at B = 16, its
# 256^2 encode shapes at B = 8 and its decode at B = 248; either side of
# the boundaries tests/test_torch_instats.py pins the plans of (one
# sliced block a 126.6 KB slice at 8 x 45^2 x 512, unsliced chunks at
# 46^2; one block an image at 8 x 16^2 x 248, 124 KB; 33 channel
# groups in 11 slices of 3, and unsliced at B = 264, where they leave 25
# of 256 threads idle; one block at 2 x 96^2 x 7, two chunks at 97^2);
# one 256^2 image in many chunks;
# C = 48, and C = 7 and 13 (one element a load); f32; 512 channel groups
# in one block (two passes over each chunk) and in slices.
@pytest.mark.parametrize(
    "shape,dtype",
    [((8, 128, 128, 128), "bfloat16"), ((8, 64, 64, 128), "bfloat16"), ((8, 64, 64, 256), "bfloat16"),
     ((8, 32, 32, 256), "bfloat16"), ((8, 32, 32, 512), "bfloat16"), ((8, 16, 16, 512), "bfloat16"),
     ((8, 8, 8, 512), "bfloat16"), ((16, 256, 256, 64), "bfloat16"),
     ((8, 256, 256, 64), "bfloat16"), ((8, 128, 128, 64), "bfloat16"), ((248, 8, 8, 512), "bfloat16"),
     ((248, 16, 16, 512), "bfloat16"), ((248, 128, 128, 128), "bfloat16"), ((248, 256, 256, 64), "bfloat16"),
     ((8, 45, 45, 512), "bfloat16"), ((8, 46, 46, 512), "bfloat16"), ((17, 8, 8, 512), "bfloat16"),
     ((8, 16, 16, 248), "bfloat16"), ((8, 16, 16, 264), "bfloat16"), ((264, 4, 4, 264), "bfloat16"), ((2, 96, 96, 7), "bfloat16"),
     ((2, 97, 97, 7), "bfloat16"), ((1, 256, 256, 64), "bfloat16"),
     ((3, 5, 7, 48), "bfloat16"), ((2, 61, 67, 7), "bfloat16"), ((3, 40, 40, 13), "float32"),
     ((4, 64, 64, 64), "float32"), ((264, 2, 2, 4096), "bfloat16"), ((2, 16, 16, 4096), "bfloat16")],
)
def test_moments_kernel_matches_plain(dev, shape, dtype):
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(shape, generator=g, device=dev).to(getattr(torch, dtype))
    before = instance_moments.launches
    m, m2 = instance_moments(x)
    assert instance_moments.launches == before + 1
    rm, rm2 = _moments_ref(x)
    # f32 sums of O(1) values in another order.
    assert float((m - rm).abs().max()) <= 1e-5
    assert float((m2 - rm2).abs().max()) <= 1e-5


# (S, slices) the planner does not pick at (8, 64, 64, 128): chunks and
# slices together (a ticket a slice), odd S, 32-byte slices, one block
# an image, and chunks of one pass (a load depth of 1) and of four.
@pytest.mark.parametrize("splits,slices", [(4, 4), (16, 2), (5, 8), (1, 16), (1, 1), (128, 1), (64, 2)])
def test_moments_kernel_takes_any_plan(dev, splits, slices):
    x = torch.randn((8, 64, 64, 128), generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    x = x.to(torch.bfloat16)
    chunk = -(-64 * 64 // splits)
    m, m2 = _launch(x, -(-64 * 64 // chunk), chunk, slices)
    rm, rm2 = _moments_ref(x)
    assert float((m - rm).abs().max()) <= 1e-5
    assert float((m2 - rm2).abs().max()) <= 1e-5


@pytest.mark.parametrize("shape", [(16, 256, 256, 64), (8, 128, 128, 128), (8, 64, 64, 128), (8, 8, 8, 512)])
def test_moments_kernel_is_bitwise_repeatable(dev, shape):
    x = _randn(np.random.default_rng(8), shape).to(dev, torch.bfloat16)
    first = instance_moments(x)
    for _ in range(3):
        again = instance_moments(x)
        assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])


# (B, H, C) of the norms the served 256^2 Generator applies: the
# decode's six at B = 32 (8^2 x 512 ... 256^2 x 64, 15 applies a decode)
# and the encoder's other three; the train cell's B = 4; odd sizes: one
# 8-channel group, 33 groups (a pass of 256 threads leaves 25 idle) and
# 512 groups (two channel passes).
NORM_SHAPES = [(32, 8, 512), (32, 16, 512), (32, 32, 512), (32, 64, 256), (32, 128, 128), (32, 256, 64),
               (32, 128, 64), (32, 64, 128), (32, 32, 256), (4, 256, 64), (4, 128, 128), (4, 8, 512),
               (3, 5, 8), (2, 7, 264), (2, 4, 4096)]
LEAKY = 0.2001953125  # 0.2 rounded to bf16, as models/stargan.py::leaky_relu takes it


def _norm_args(dev, b, h, c, scale=1.0):
    """NCHW channels_last bf16 x (channel 0 constant: variance 0, so the
    clamp and eps decide), its kernel moments, and the two variants'
    arguments: an affine pair, an AdaIN dense output."""
    g = torch.Generator(device=dev).manual_seed(b * h + c)
    x = torch.randn((b, h, h, c), generator=g, device=dev) * 3 + 1
    x[..., 0] = 2.5
    x = (x * scale).to(torch.bfloat16).permute(0, 3, 1, 2)
    m, m2 = instance_moments(x.permute(0, 2, 3, 1))
    affine = dict(weight=1 + 0.5 * torch.randn(c, generator=g, device=dev),
                  bias=0.5 * torch.randn(c, generator=g, device=dev))
    style = dict(style=(torch.randn((b, 2 * c), generator=g, device=dev) * 0.5).to(torch.bfloat16))
    return x, m, m2, (affine, style)


def _assert_same_bytes(got, want, what):
    gi = got.permute(0, 2, 3, 1).contiguous().view(torch.int16)
    wi = want.permute(0, 2, 3, 1).contiguous().view(torch.int16)
    bad = (gi != wi).nonzero()
    assert bad.numel() == 0, (what, bad.shape[0], bad[:4].tolist(),
                              got.permute(0, 2, 3, 1)[tuple(bad[:4].T)].tolist(),
                              want.permute(0, 2, 3, 1)[tuple(bad[:4].T)].tolist())


@pytest.mark.parametrize("shape", NORM_SHAPES)
def test_norm_apply_kernel_equals_the_composite_byte_for_byte(dev, shape):
    """Each variant (affine, AdaIN), one launch each, the same bytes as
    the eager composite."""
    x, m, m2, variants = _norm_args(dev, *shape)
    with torch.no_grad():
        for kw in variants:
            before = norm_apply.launches
            got = norm_apply(x, m, m2, 1e-5, LEAKY, **kw)
            assert norm_apply.launches == before + 1
            assert got.is_contiguous(memory_format=torch.channels_last)
            _assert_same_bytes(got, norm_apply_ref(x, m, m2, 1e-5, LEAKY, **kw), (shape, sorted(kw)))


@pytest.mark.parametrize("scale", [1e15, 3e-3])
def test_norm_apply_kernel_at_large_and_small_magnitudes(dev, scale):
    x, m, m2, variants = _norm_args(dev, 4, 32, 256, scale)
    assert bool(torch.isfinite(m2).all())
    with torch.no_grad():
        for kw in variants:
            _assert_same_bytes(norm_apply(x, m, m2, 1e-5, LEAKY, **kw),
                               norm_apply_ref(x, m, m2, 1e-5, LEAKY, **kw), (scale, sorted(kw)))


def _generator_256(dev):
    """The served 256^2 Generator in bf16, seeded, its norms' affine
    pairs drawn away from 1 and 0."""
    from ppvision_tpu_torch.models import stargan

    gen = stargan.init_params_(stargan.Generator(256, 64, 512, 1.0, dtype=torch.bfloat16), seed=0)
    with torch.no_grad():
        for mod in gen.modules():
            if isinstance(mod, stargan.InstanceNorm):
                mod.weight.normal_(1.0, 0.3)
                mod.bias.normal_(0.0, 0.3)
    return gen.to(dev)


def test_generator_decode_applies_each_norm_in_one_launch(dev, monkeypatch):
    """A no-grad decode of the served 256^2 Generator at B = 32 applies
    its 15 norms in 15 kernel launches and no composite call, and its
    output equals, byte for byte, the decode with the composite in the
    kernel's place; under autograd with trainable weights the composite
    runs all 15."""
    from ppvision_tpu_torch.models import stargan

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    gen = _generator_256(dev)
    g = torch.Generator(device=dev).manual_seed(5)
    z = torch.randn((32, 8, 8, 512), generator=g, device=dev).permute(0, 3, 1, 2)
    s = torch.randn((32, 64), generator=g, device=dev)
    with torch.no_grad():
        counts = (norm_apply.launches, norm_apply.eager)
        got = gen.decode(z, s)
        assert (norm_apply.launches - counts[0], norm_apply.eager - counts[1]) == (15, 0)
        monkeypatch.setattr(stargan, "norm_apply", norm_apply_ref)
        want = gen.decode(z, s)
        monkeypatch.setattr(stargan, "norm_apply", norm_apply)
    assert torch.equal(got.contiguous().view(torch.int32), want.contiguous().view(torch.int32))
    with torch.enable_grad():
        counts = (norm_apply.launches, norm_apply.eager)
        out = gen.decode(z[:2], s[:2])
        assert out.requires_grad
        assert (norm_apply.launches - counts[0], norm_apply.eager - counts[1]) == (0, 15)


def test_generator_forward_at_the_train_batch_equals_the_composite(dev, monkeypatch):
    """The GAN step's no-grad forwards (the fakes of the D sub-steps):
    ``Generator.forward`` at B = 4 with the high-pass skips, encoder and
    decoder, launches the kernel for all 29 norms and gives the bytes of
    the same forward with the composite in the kernel's place."""
    from ppvision_tpu_torch.models import stargan

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    gen = _generator_256(dev)
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.rand((4, 256, 256, 3), generator=g, device=dev).permute(0, 3, 1, 2) * 2 - 1
    masks = tuple(torch.rand((4, 1, 256, 256), generator=g, device=dev) for _ in range(2))
    s = torch.randn((4, 64), generator=g, device=dev)
    with torch.no_grad():
        counts = (norm_apply.launches, norm_apply.eager)
        got = gen(x, s, masks)
        assert (norm_apply.launches - counts[0], norm_apply.eager - counts[1]) == (29, 0)
        monkeypatch.setattr(stargan, "norm_apply", norm_apply_ref)
        want = gen(x, s, masks)
    assert torch.equal(got.contiguous().view(torch.int32), want.contiguous().view(torch.int32))


# The paths' shapes, among them those whose tiles span images (8^2, 4^2)
# and K = 64 (a 64-wide output-channel tile); the eval's style encoder at
# a source batch's 80 reference faces (its largest and smallest); K = 16
# and 80 (a masked last tile); a ragged edge; a tile of three 4^2 images.
@pytest.mark.parametrize(
    "shape",
    [(8, 128, 128, 128, 128), (8, 64, 64, 128, 256), (10, 4, 4, 512, 512), (2, 5, 7, 48, 32),
     (16, 256, 256, 64, 64), (16, 128, 128, 64, 128), (8, 16, 16, 512, 512), (8, 8, 8, 512, 512),
     (8, 32, 32, 512, 512), (80, 128, 128, 64, 128), (80, 4, 4, 512, 512),
     (2, 8, 8, 32, 16), (2, 9, 12, 64, 80), (3, 4, 4, 64, 64)],
)
def test_conv3x3_kernel_matches_plain(dev, shape):
    b, h, w, c, k = shape
    rng = np.random.default_rng(3)
    x = _randn(rng, (b, h, w, c)).to(dev, torch.bfloat16)
    ker = _randn(rng, (3, 3, c, k), 1 / math.sqrt(9 * c)).to(dev, torch.bfloat16)
    before = conv3x3.launches
    got = conv3x3(x, ker).float()
    assert conv3x3.launches == before + 1
    want = conv3x3_ref(x, ker).float()
    assert float((got - want).abs().max()) / float(want.abs().max()) < 2e-2


def test_conv3x3_packed_weight_is_bit_identical(dev):
    rng = np.random.default_rng(9)
    x = _randn(rng, (2, 16, 16, 128)).to(dev, torch.bfloat16)
    ker = _randn(rng, (3, 3, 128, 256), 1 / math.sqrt(9 * 128)).to(dev, torch.bfloat16)
    assert torch.equal(conv3x3(x, pack_conv3x3_weight(ker)), conv3x3(x, ker))


def _corr_inputs(rng, b, h, h2, c, spread, w=None, w2=None):
    """fmap1 (b, h, w, c), fmap2 (b, h2, w2, c) and coords on fmap2's
    grid scaled to the queries' plus a uniform +-spread px."""
    w, w2 = w or h, w2 or h2
    f1 = _randn(rng, (b, h, w, c))
    f2 = _randn(rng, (b, h2, w2, c))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack([xs * (w2 / w), ys * (h2 / h)], -1)
    coords = torch.from_numpy((grid + rng.uniform(-spread, spread, (b, h, w, 2))).astype(np.float32))
    return f1, f2, coords


def _corr_close(got, want):
    # f32 dots of C terms summed in another order (no TF32 on either side).
    assert float((got - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("h2", [32, 16, 8, 4])  # RAFT's four levels at 256^2
def test_corr_kernel_matches_plain(dev, h2):
    rng = np.random.default_rng(5)
    f1, f2, coords = (t.to(dev) for t in _corr_inputs(rng, 4, 32, h2, 256, 6.0))
    before = local_corr.launches
    got = local_corr(f1, f2, coords, 4)
    assert local_corr.launches == before + 1
    _corr_close(got, local_corr_ref(f1, f2, coords, 4))
    for far in (coords + 100.0, coords - 100.0):
        assert torch.equal(local_corr(f1, f2, far, 4), torch.zeros_like(got))


# (b, h, w, h2, w2, c, r, spread): radii 0, 1, 4 and 16; C = 4 .. 512;
# maps smaller than the window with H2 != W2; a band that is not whole
# rows; and coords over the whole 64^2 map and r + 2 px past it, whose
# box is larger than a block's ring (it is walked in tiles).
CORR_CASES = [
    (2, 16, 16, 16, 16, 64, 0, 3.0), (2, 16, 16, 16, 16, 64, 1, 3.0),
    (1, 12, 12, 12, 12, 32, 16, 20.0), (2, 9, 7, 9, 7, 128, 16, 4.0),
    (3, 16, 16, 8, 8, 4, 4, 5.0), (2, 16, 16, 16, 16, 128, 4, 5.0), (2, 16, 16, 16, 16, 512, 4, 5.0),
    (2, 10, 12, 3, 5, 256, 4, 6.0), (1, 8, 8, 2, 7, 36, 3, 4.0), (2, 5, 13, 6, 11, 20, 2, 2.0),
]


@pytest.mark.parametrize("case", CORR_CASES)
def test_corr_kernel_matches_plain_at_other_shapes(dev, case):
    b, h, w, h2, w2, c, r, spread = case
    rng = np.random.default_rng(9)
    f1, f2, coords = (t.to(dev) for t in _corr_inputs(rng, b, h, h2, c, spread, w, w2))
    _corr_close(local_corr(f1, f2, coords, r), local_corr_ref(f1, f2, coords, r))


def _whole_map_spread(rng, r=4):
    """B=2, 64x64 queries on a 64x64 map at C=256, coords uniform over the
    map and r + 2 px beyond each border."""
    f1, f2, _ = _corr_inputs(rng, 2, 64, 64, 256, 0.0)
    coords = torch.from_numpy(rng.uniform(-(r + 2), 63 + r + 2, (2, 64, 64, 2)).astype(np.float32))
    return f1, f2, coords


def test_corr_kernel_whole_map_spread(dev):
    f1, f2, coords = (t.to(dev) for t in _whole_map_spread(np.random.default_rng(10)))
    plan = plan_corr(2, 64 * 64, 256, 64, 64, 4)
    assert plan.cap < 64 * 64 * (plan.cw // 4 + 1)  # the box cannot be staged whole
    _corr_close(local_corr(f1, f2, coords, 4), local_corr_ref(f1, f2, coords, 4))


@pytest.mark.parametrize("cw,cap", [(16, 12), (16, 30), (16, 200), (32, 100), (64, 800)])
def test_corr_kernel_takes_any_plan(dev, cw, cap):
    """Channel steps of 16-64 and rings smaller than a box row (tiles of
    row pieces) or than the box, through ``_launch`` with an explicit
    plan (bands of 40 queries, which end mid-row)."""
    rng = np.random.default_rng(11)
    f1, f2, coords = (t.to(dev) for t in _corr_inputs(rng, 2, 16, 16, 64, 4.0))
    plan = plan_corr(2, 256, 64, 16, 16, 4)._replace(qb=40, cw=cw, cap=cap)
    _corr_close(_corr_launch(f1, f2, coords, 4, plan), local_corr_ref(f1, f2, coords, 4))


def test_corr_kernel_is_bitwise_repeatable(dev):
    rng = np.random.default_rng(12)
    f1, f2, coords = (t.to(dev) for t in _corr_inputs(rng, 30, 32, 32, 256, 6.0))
    assert torch.equal(local_corr(f1, f2, coords, 4), local_corr(f1, f2, coords, 4))
    f1, f2, coords = (t.to(dev) for t in _whole_map_spread(rng))
    assert torch.equal(local_corr(f1, f2, coords, 4), local_corr(f1, f2, coords, 4))


def test_corr_backward_on_the_card_matches_cpu(dev):
    rng = np.random.default_rng(6)
    cpu = list(_corr_inputs(rng, 2, 8, 8, 64, 3.0))
    g = _randn(rng, (2, 8, 8, 81))
    grads = {}
    for d in ("cpu", dev):
        ts = [t.clone().to(d).requires_grad_() for t in cpu]
        local_corr(*ts, 4).backward(g.to(d))
        grads[str(d)] = [t.grad.cpu() for t in ts]
    for a, b in zip(grads["cpu"], grads[str(dev)]):
        assert float((a - b).abs().max()) <= 1e-4 * max(1.0, float(a.abs().max()))


def test_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros((1, 8, 8, 24), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        conv3x3(x, torch.zeros((3, 3, 24, 16), dtype=torch.bfloat16, device=dev))
    for bad in (x.float(), torch.zeros((1, 8, 8, 64), dtype=torch.bfloat16, device=dev)):
        with pytest.raises(ValueError):
            fused_dense_block(bad, *([None] * 3), *([None] * 3))
    coords = torch.zeros((1, 8, 8, 2), device=dev)
    with pytest.raises(ValueError):
        local_corr(x, x, coords)  # bf16
    with pytest.raises(ValueError):
        local_corr(x.float()[..., :6], x.float()[..., :6], coords)  # C % 4 != 0
    wide = torch.zeros((1, 8, 8, 516), device=dev)
    with pytest.raises(ValueError):
        local_corr(wide, wide, coords)  # C > 512
    xn = torch.zeros((2, 16, 8, 8), dtype=torch.bfloat16, device=dev)
    m = torch.zeros((2, 16), device=dev)
    w, b = torch.ones(16, device=dev), torch.zeros(16, device=dev)
    for bad in (dict(style=torch.zeros((2, 16), dtype=torch.bfloat16, device=dev)),  # not (B, 2C)
                dict(weight=w),  # no bias
                {},  # neither an affine nor a style
                dict(weight=w, bias=b, style=torch.zeros((2, 32), dtype=torch.bfloat16, device=dev)),  # both
                dict(weight=torch.ones(16), bias=torch.zeros(16))):  # on the host
        with pytest.raises(ValueError):
            norm_apply(xn, m, m, 1e-5, 0.2, **bad)
    with pytest.raises(ValueError):
        norm_apply(xn, m[:1], m, 1e-5, 0.2, weight=w, bias=b)


def test_raft_matmul_conv_matches_cudnn(dev):
    from ppvision_tpu_torch.models.raft import _MatmulConv2d

    conv = _MatmulConv2d(256, 192, 3, padding=1).to(dev)
    x = _randn(np.random.default_rng(8), (3, 256, 10, 12)).to(dev)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want = torch.nn.functional.conv2d(x, conv.weight, conv.bias, padding=1)
        err = float((conv(x) - want).abs().max())
    # True f32 on both sides: sums of 2304 products in another order.
    assert err <= 1e-5 * float(want.abs().max()), err


def _raft_pair(frames: str, b: int, size: int):
    """RAFT's two (b, size, size, 3) 0-255 inputs: uniform noise and the
    same rolled 2 px, or frames t and t + 1 of the video path's seeded
    smooth image moving 1 px a frame (``chip_smoke.smooth_frames``)."""
    if frames == "noise":
        im1 = torch.from_numpy(np.random.default_rng(7).uniform(0, 255, (b, size, size, 3)).astype(np.float32))
        return im1, torch.roll(im1, 2, dims=2)
    import chip_smoke

    video = torch.from_numpy(chip_smoke.smooth_frames(b + 1, size, 21)) * 255.0
    return video[:-1], video[1:]


# B = 2 at 64^2 on 3 levels, and at the video path's 256^2 on its 4.
@pytest.mark.parametrize("frames,size,levels", [("noise", 64, 3), ("smooth", 256, 4)])
def test_raft_alternate_matches_dense_on_the_card(dev, frames, size, levels):
    from ppvision_tpu_torch.models.raft import build_raft

    alt = build_raft(0, dev, iters=3, corr_levels=levels, alternate_corr=True)
    dense = build_raft(0, dev, iters=3, corr_levels=levels)
    im1, im2 = (t.to(dev) for t in _raft_pair(frames, 2, size))
    before = local_corr.launches
    with torch.no_grad():
        a, d = alt(im1, im2), dense(im1, im2)
    assert local_corr.launches == before + levels * 3  # one launch a level a step
    scale = float(d.abs().max()) + 1e-6
    # The JAX package's own tolerance for this equivalence (tests/test_raft.py).
    assert torch.allclose(a, d, atol=2e-4 * scale, rtol=1e-4), float((a - d).abs().max())


def test_raft_on_the_card_matches_cpu(dev):
    """The alternate 4-level RAFT on the card against the port's CPU RAFT,
    same weights: B = 1, the smooth frames average-pooled to 128^2, 3
    iterations.  True f32 on both sides (TF32 off); sums in another order
    through the encoders and 3 refinement steps: the same scale-relative
    bound as against the dense path."""
    from ppvision_tpu_torch.models.raft import build_raft

    im1, im2 = (torch.nn.functional.avg_pool2d(t.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
                for t in _raft_pair("smooth", 1, 256))
    card = build_raft(0, dev, corr_levels=4, alternate_corr=True)
    cpu = build_raft(0, "cpu", corr_levels=4, alternate_corr=True)
    with torch.no_grad():
        got = card(im1.to(dev), im2.to(dev), iters=3).cpu()
        want = cpu(im1, im2, iters=3)
    scale = float(want.abs().max()) + 1e-6
    assert torch.allclose(got, want, atol=2e-4 * scale, rtol=1e-4), float((got - want).abs().max())


# B = 2, R = 2: at 64^2 with small widths, and at 128^2 full width.
@pytest.mark.parametrize("img,camera_n,widths,seed", [
    (64, 32, dict(style_dim=16, latent_dim=8, max_conv_dim=64), 4),
    (128, 128, {}, 7),
])
def test_deid_path_runs_every_kernel_and_matches_cpu(dev, img, camera_n, widths, seed):
    from ppvision_tpu_torch.config import CameraConfig, FaceDeIdConfig, ModelConfig
    from ppvision_tpu_torch.deid import build_deid, deid_multi_style
    from ppvision_tpu_torch.ops import DEID_KERNELS, KERNELS

    rng = np.random.default_rng(seed)
    xs = torch.from_numpy(rng.random((2, img, img, 3), dtype=np.float32))
    xr = torch.from_numpy(rng.random((2, img, img, 3), dtype=np.float32))
    yr = torch.tensor([0, 1])
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = FaceDeIdConfig(model=ModelConfig(img_size=img, compute_dtype=dtype, **widths),
                             camera=CameraConfig(n=camera_n))
        for d in ("cuda", "cpu"):
            for fn in KERNELS.values():
                fn.launches = 0
            out[dtype, d] = deid_multi_style(build_deid(0, cfg, device=d), xs, xr, yr).cpu().numpy()
            if d == "cuda" and dtype == "bfloat16":
                assert all(KERNELS[k].launches > 0 for k in DEID_KERNELS)
    ref = out["float32", "cpu"]
    # True-f32 math on both sides (TF32 off); differences are summation
    # order through ~60 layers, so the bound is relative to the output scale.
    assert np.abs(out["float32", "cuda"] - ref).max() <= 2e-3 * max(1.0, np.abs(ref).max())
    # bf16 rounds at the same ops on both sides, but a 1-ulp change in a
    # conv sum propagates through the random-weight nets as far as bf16
    # itself departs from f32: the card's bf16 run sits no further from
    # the CPU's than that run sits from f32, at the 99th percentile and
    # at the max.
    noise = np.abs(out["bfloat16", "cpu"] - ref)
    d16 = np.abs(out["bfloat16", "cuda"] - out["bfloat16", "cpu"])
    for q in (0.99, 1.0):
        assert np.quantile(d16, q) <= 1.5 * np.quantile(noise, q) + 1e-3, (q, np.quantile(d16, q))


def test_server_copy_stream_keeps_every_output_byte_for_byte(dev, monkeypatch):
    """``DeIdServer`` on the card copies each batch's output into fresh
    pinned memory on its copy stream: a bf16 64^2 bundle, 3 batches of 4
    at depth 2 in uint8, every output kept to the end, equal byte for
    byte to the same server copying by ``.cpu()`` on the compute stream;
    at least one drain found its copy done."""
    from ppvision_tpu_torch.config import CameraConfig, FaceDeIdConfig, ModelConfig
    from ppvision_tpu_torch.deid import build_deid
    from ppvision_tpu_torch.serve import DeIdServer

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = FaceDeIdConfig(model=ModelConfig(img_size=64, style_dim=16, latent_dim=8, max_conv_dim=64,
                                           compute_dtype="bfloat16"), camera=CameraConfig(n=32))
    bundle = build_deid(0, cfg, device=dev)
    rng = np.random.default_rng(19)
    imgs = [rng.random((64, 64, 3), dtype=np.float32) for _ in range(12)]
    xr = rng.random((2, 64, 64, 3), dtype=np.float32)
    yr = np.array([0, 1])
    outs, stats = {}, {}
    for tag in ("copy stream", ".cpu()"):
        server = DeIdServer(bundle, xr, yr, batch_size=4, depth=2, out_space="uint8")
        if tag == ".cpu()":
            server._copy_out = lambda out, number: (out.cpu(), None)
        server.warmup()
        outs[tag] = list(server.serve(imgs))
        stats[tag] = server.stats()
    assert len(outs["copy stream"]) == 12 and all(o.dtype == np.uint8 for o in outs["copy stream"])
    for got, want in zip(outs["copy stream"], outs[".cpu()"]):
        np.testing.assert_array_equal(got, want)
    assert stats["copy stream"]["batches_dispatched"] == 3
    assert 1 <= stats["copy stream"]["copies_ready"] <= 3 and stats[".cpu()"]["copies_ready"] == 0


# ---------------------------------------------------------------------------
# Gradients through the kernels (the training slice).  Each kernel's
# backward is its plain version's VJP; conv3x3's is differentiable again.
# ---------------------------------------------------------------------------


def _rel(got, want) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max()) / (float(want.abs().max()) + 1e-12)


# Every conv3x3 shape of the train path (chip_smoke.CONV3X3_SHAPES at
# TRAIN_B = 4): the 256^2 generator, the style encoder and the
# discriminator.
@pytest.mark.parametrize("shape", [(4, 256, 256, 64, 64), (4, 128, 128, 64, 128), (4, 128, 128, 128, 128),
                                   (4, 64, 64, 128, 256), (4, 64, 64, 256, 256), (4, 32, 32, 256, 512),
                                   (4, 32, 32, 512, 512), (4, 16, 16, 512, 512), (4, 8, 8, 512, 512),
                                   (4, 4, 4, 512, 512)])
def test_conv3x3_grads_and_r1_second_order_match_plain(dev, shape):
    b, h, w, c, k = shape
    rng = np.random.default_rng(6)
    x = _randn(rng, (b, h, w, c)).to(dev, torch.bfloat16).requires_grad_(True)
    wt = _randn(rng, (3, 3, c, k), 1 / math.sqrt(9 * c)).to(dev, torch.bfloat16).requires_grad_(True)
    cot = _randn(rng, (b, h, w, k)).to(dev)
    packed = pack_conv3x3_weight(wt.detach())
    grads = []
    for fn in (lambda x, w: conv3x3(x, w, packed), conv3x3_ref):
        y = fn(x, wt)
        assert y.grad_fn is not None
        dx, dw = torch.autograd.grad((y.float() * cot).sum(), (x, wt), retain_graph=True)
        # R1: the sign pattern of the nonlinearity comes from each side's own forward.
        (dx2,) = torch.autograd.grad((torch.nn.functional.leaky_relu(y.float(), 0.2) * cot).sum(), x,
                                     create_graph=True)
        (r1,) = torch.autograd.grad(dx2.float().square().sum(), wt)
        grads.append((dx, dw, r1))
    for got, want in zip(*grads):
        assert _rel(got, want) < 2e-2


# Every instats shape of the train path (chip_smoke.INSTATS_SHAPES at
# TRAIN_B = 4).
@pytest.mark.parametrize("shape", [(4, 256, 256, 64), (4, 128, 128, 64), (4, 128, 128, 128), (4, 64, 64, 128),
                                   (4, 64, 64, 256), (4, 32, 32, 256), (4, 32, 32, 512), (4, 16, 16, 512),
                                   (4, 8, 8, 512)])
def test_moments_grads_match_plain(dev, shape):
    rng = np.random.default_rng(7)
    x = _randn(rng, shape).to(dev, torch.bfloat16).requires_grad_(True)
    gm, gm2 = _randn(rng, (2, shape[0], shape[-1])).to(dev)
    m, m2 = instance_moments(x)
    assert m.grad_fn is not None and m2.grad_fn is not None
    (got,) = torch.autograd.grad((m * gm).sum() + (m2 * gm2).sum(), x)
    rm, rm2 = _moments_ref(x)
    (want,) = torch.autograd.grad((rm * gm).sum() + (rm2 * gm2).sum(), x)
    assert _rel(got, want) < 2e-2


def test_fftconv_and_denseblock_grads_match_plain(dev):
    rng = np.random.default_rng(8)
    img = _randn(rng, (2, 64, 64, 3)).to(dev).requires_grad_(True)
    otf = torch.fft.fft2(_randn(rng, (64, 64, 3)).to(dev), dim=(0, 1))
    ore, oim = otf.real.contiguous().requires_grad_(True), otf.imag.contiguous().requires_grad_(True)
    cot = _randn(rng, (2, 64, 64, 3)).to(dev)
    y = fftconv_circular(img, ore, oim)
    assert y.grad_fn is not None
    got = torch.autograd.grad((y * cot).sum(), (img, ore, oim))
    want = torch.autograd.grad((fftconv_circular_ref(img, ore, oim) * cot).sum(), (img, ore, oim))
    for a, w in zip(got, want):
        assert _rel(a, w) < 1e-4

    f = 256
    x = _randn(rng, (2, 16, 16, f)).to(dev, torch.bfloat16).requires_grad_(True)
    ks = [_randn(rng, s, 1 / math.sqrt(9 * s[2])).to(dev, torch.bfloat16).requires_grad_(True)
          for s in ((3, 3, f, f // 2), (3, 3, f // 2, f // 4), (3, 3, f // 4, f // 4))]
    bns = [(1 + 0.1 * _randn(rng, (c,))).to(dev) for c in (f, f, f // 2, f // 2, f // 4, f // 4)]
    pairs = list(zip(bns[0::2], bns[1::2]))
    cot = _randn(rng, (2, 16, 16, f)).to(dev)
    y = fused_dense_block(x, *ks, *pairs)
    assert y.grad_fn is not None
    got = torch.autograd.grad((y.float() * cot).sum(), (x, *ks))
    want = torch.autograd.grad((dense_block_ref(x, *ks, *pairs).float() * cot).sum(), (x, *ks))
    for a, w in zip(got, want):
        assert _rel(a, w) < 2e-2


def test_instance_norm_grad_on_the_card_matches_cpu(dev):
    """InstanceNorm's gradient through the moments kernel: its mean and
    variance terms reach x (they were dropped before the kernel had a
    backward)."""
    from ppvision_tpu_torch.models.stargan import InstanceNorm

    rng = np.random.default_rng(9)
    x = _randn(rng, (4, 64, 32, 32)).contiguous(memory_format=torch.channels_last) * 3 + 1
    cot = _randn(rng, (4, 64, 32, 32))
    norm = InstanceNorm(64)
    grads = {}
    for d in ("cpu", dev):
        xd = x.to(d).requires_grad_(True)
        (grads[str(d)],) = torch.autograd.grad((norm.to(d)(xd) * cot.to(d)).sum(), xd)
    assert _rel(grads[str(dev)].cpu(), grads["cpu"]) < 1e-4


def test_packed_weight_follows_an_optimizer_step(dev):
    """A Conv's cached packed kernel weight is repacked after
    ``optimizer.step()`` updates the weight in place."""
    from ppvision_tpu_torch.models.stargan import Conv

    conv = Conv(64, 64, 3, 1, 1, dtype=torch.bfloat16).to(dev)
    opt = torch.optim.Adam(conv.parameters(), lr=1e-2, foreach=True)
    x = torch.randn((2, 64, 16, 16), device=dev).contiguous(memory_format=torch.channels_last)
    launches = conv3x3.launches
    conv(x).float().square().mean().backward()
    before = conv.packed_weight(torch.bfloat16).clone()
    opt.step()
    y = conv(x)
    assert conv3x3.launches == launches + 2
    assert not torch.equal(conv.packed_weight(torch.bfloat16), before)
    xb = x.to(torch.bfloat16).permute(0, 2, 3, 1)
    want = conv3x3_ref(xb, conv.weight.detach().permute(2, 3, 1, 0).to(torch.bfloat16)).permute(0, 3, 1, 2)
    want = want + conv.bias.detach().to(torch.bfloat16)[:, None, None]
    assert _rel(y.detach(), want) < 2e-2


def _small_train_cfg(dtype: str):
    """The 64^2 train configuration: max_conv_dim 64, FAN at 64, camera
    n = 64, RAFT's flow loss at 3 iterations."""
    from ppvision_tpu_torch.config import CameraConfig, FaceDeIdConfig, ModelConfig, TrainConfig

    return FaceDeIdConfig(model=ModelConfig(img_size=64, max_conv_dim=64, fan_input_size=64, compute_dtype=dtype),
                          camera=CameraConfig(n=64), train=TrainConfig(flow_iters=3))


def _plain_kernels(mp: pytest.MonkeyPatch) -> None:
    """Point the names the modules call the four de-id kernels by (and
    the norm apply, instats' second entry point) at their plain versions."""
    from ppvision_tpu_torch.models import fan, stargan
    from ppvision_tpu_torch.ops import denseblock, fftconv, instats, winograd
    from ppvision_tpu_torch.optics import fourier

    def conv(x, w, packed=None):
        return winograd.conv3x3_ref(x, w if w is not None else winograd.unpack_conv3x3_weight(packed, x.shape[-1]))

    def dense(x, k1, k2, k3, *bn):
        return denseblock._plain(x, k1, k2, k3, *denseblock._flat_bn(bn))

    for mod, name, fn in ((stargan, "conv3x3", conv), (stargan, "instance_moments", instats._moments_ref),
                          (stargan, "norm_apply", instats.norm_apply_ref), (fan, "fused_dense_block", dense),
                          (fourier, "fftconv_circular", fftconv.fftconv_circular_ref)):
        mp.setattr(mod, name, fn)


# The runs of one 64^2 train step (B = 2), (dtype, device) each.  The
# first run of a case is its teacher: every run applies its gradients.
TRAIN_RUNS = {"cpu32": ("float32", "cpu"), "card32": ("float32", "cuda"), "card16": ("bfloat16", "cuda"),
              "cpu16": ("bfloat16", "cpu"), "card16_plain": ("bfloat16", "cuda")}


@pytest.mark.parametrize("runs", [("cpu32", "card32", "card16"),
                                  ("cpu16", "card16", "card16_plain", "cpu32", "card32")])
def test_train_step_runs_every_kernel_and_matches_cpu(dev, runs):
    """One train step at 64^2 (B = 2) on the card and on the CPU, same
    weights and batch.  Each run applies the first run's gradients, so
    each sub-step starts from the same weights everywhere (Adam's first
    step turns a flipped near-zero gradient sign into a 2 lr move of its
    weight).  In f32 (TF32 off) every loss within 2e-2 and each gradient
    at cosine >= 0.98; in bf16 the four de-id kernels launch.  With the
    CPU bf16 run as the teacher (on ``chip_smoke.train_batches``' seed
    37 batch), each bf16 loss and gradient is also no further from the
    CPU f32 run than 1.5x the farther of two other bf16 runs (the CPU's,
    and the card's with the plain versions in place of the kernels,
    which launches none), nor than 1.5x the f32 bounds: with random
    weights the generator's L1 terms take the sign of small differences,
    so in bf16 its gradient is mostly rounding noise, and ``G/ref_ds``
    (the mean of a difference of two fakes) moves between bf16 runs by
    more than the f32 bound."""
    import chip_smoke
    from ppvision_tpu_torch.ops import DEID_KERNELS, KERNELS

    if runs[0] == "cpu32":
        rng = np.random.default_rng(10)
        batch = dict(x_src=rng.random((2, 64, 64, 3), dtype=np.float32),
                     x_ref=rng.random((2, 64, 64, 3), dtype=np.float32),
                     x_ref2=rng.random((2, 64, 64, 3), dtype=np.float32), y_src=np.array([0, 1]),
                     y_ref=np.array([1, 0]), z_trg=rng.standard_normal((2, 16), dtype=np.float32),
                     z_trg2=rng.standard_normal((2, 16), dtype=np.float32))
    else:
        batch = chip_smoke.train_batches(_small_train_cfg("float32"), 1, 2, seed=37)[0]
    out, teacher = {}, {}
    for name in runs:
        dtype, d = TRAIN_RUNS[name]
        cfg = _small_train_cfg(dtype)
        grads = {}

        def hook(sub, by_net):
            for net, gs in by_net.items():
                grads[sub, net] = torch.cat([g.detach().double().flatten().cpu() for g in gs])
            if sub not in teacher:
                teacher[sub] = {net: [g.detach().cpu().clone() for g in gs] for net, gs in by_net.items()}
                return None
            return {net: [g.to(gs[0].device) for g in teacher[sub][net]] for net, gs in by_net.items()}

        for fn in KERNELS.values():
            fn.launches = 0
        with pytest.MonkeyPatch.context() as mp:
            if name == "card16_plain":
                _plain_kernels(mp)
            state, frozen, step = chip_smoke.build_trainer(cfg, d, grad_hook=hook)
            losses = {k: float(v) for k, v in step(state, frozen, batch).items()}
        out[name] = losses, grads
        assert all(np.isfinite(v) for v in losses.values()), name
        if name == "card16":
            assert all(KERNELS[k].launches > 0 for k in DEID_KERNELS)
        if name == "card16_plain":
            assert not any(fn.launches for fn in KERNELS.values())

    def rel(a, b):
        return {k: abs(out[a][0][k] - out[b][0][k]) / max(abs(out[b][0][k]), 1e-6) for k in out[b][0]}

    def angle(a, b):  # 1 - cosine
        ga, gb = out[a][1], out[b][1]
        return {key: 1 - float(ga[key] @ gb[key] / (ga[key].norm() * gb[key].norm() + 1e-30)) for key in gb}

    (lc, gc), (lg, gg) = out["cpu32"], out["card32"]
    for k in lc:
        assert abs(lg[k] - lc[k]) <= 2e-2 * max(abs(lc[k]), 1e-6), k
    for key in gc:
        cos = float(gg[key] @ gc[key] / (gg[key].norm() * gc[key].norm() + 1e-30))
        assert cos >= 0.98, (key, cos)
    if "card16_plain" not in runs:
        return
    for measure in (rel, angle):
        got, cpu16, plain16 = (measure(run, "cpu32") for run in ("card16", "cpu16", "card16_plain"))
        for k, v in got.items():
            assert v <= 1.5 * max(cpu16[k], plain16[k], 2e-2), (measure.__name__, k, v, cpu16[k], plain16[k])


# (B, H, C, O, up) of the int8 decode's products: every shape of
# chip_smoke.int8_decode_shapes (de-id at 128^2, B = 8; the 256^2
# generator at B = 4), and odd maps (up: a K4 phase with odd H).
INT8_SHAPES = [
    (8, 8, 512, 512, False), (8, 8, 512, 512, True), (8, 16, 512, 512, False), (8, 16, 512, 512, True),
    (8, 32, 512, 512, False), (8, 32, 512, 256, True), (8, 64, 256, 256, False), (8, 64, 256, 128, True),
    (8, 128, 128, 128, False),
    (4, 8, 512, 512, False), (4, 8, 512, 512, True), (4, 16, 512, 512, False), (4, 16, 512, 512, True),
    (4, 32, 512, 512, False), (4, 32, 512, 256, True), (4, 64, 256, 256, False), (4, 64, 256, 128, True),
    (4, 128, 128, 128, False), (4, 128, 128, 64, True), (4, 256, 64, 64, False),
    (2, 7, 16, 24, True), (3, 5, 8, 8, False),
]


@pytest.mark.parametrize("shape", INT8_SHAPES)
def test_int8_route_matches_plain_bit_for_bit(dev, shape):
    """The ``torch._int_mm`` route (taps; the up-conv's four phases)
    against the exact f64 conv, in int32, bit for bit; the bf16 output of
    the whole int8 conv equals the CPU path's on the same inputs."""
    from ppvision_tpu_torch.ops import quant

    b, h, c, o, up = shape
    rng = np.random.default_rng(sum(shape[:4]))
    xq = torch.from_numpy(rng.integers(-127, 128, (b, h, h + (h % 2), c)).astype(np.int8)).to(dev)
    kq = torch.from_numpy(rng.integers(-127, 128, (4 if up else 3,) * 2 + (c, o)).astype(np.int8)).to(dev)
    acc, ref = (quant.int8_up2x_acc, quant.int8_up2x_acc_ref) if up else (quant.int8_conv_acc, quant.int8_conv_acc_ref)
    before = acc.launches
    got = acc(xq, kq)
    assert acc.launches == before + 1 and got.dtype == torch.int32
    assert torch.equal(got, ref(xq, kq))
    x = _randn(rng, (b, h, h, c)).to(torch.bfloat16)
    k = _randn(rng, (3, 3, c, o), 1 / math.sqrt(9 * c))
    fn = quant.int8_conv3x3_nearest_up2x if up else quant.int8_conv
    assert torch.equal(fn(x.to(dev), k.to(dev)).cpu(), fn(x, k))


def test_int8_route_refuses_what_int_mm_does_not_take(dev):
    from ppvision_tpu_torch.ops import quant

    for shape in ((1, 4, 4, 8), (2, 4, 4, 12)):  # M = 16; C % 8
        xq = torch.zeros(shape, dtype=torch.int8, device=dev)
        with pytest.raises(ValueError, match="_int_mm"):
            quant.int8_conv_acc(xq, torch.zeros((3, 3, shape[-1], 8), dtype=torch.int8, device=dev))


def _ref_fakes(dev, cfg, seed: int, teacher: dict, teach: bool) -> list:
    """One 64^2 train step (B = 2) from seed ``seed``'s weights and batch;
    the G/ref sub-step's ``x_fake`` and ``x_fake2`` (the generator's first
    two calls after the G/latent update).  With ``teach`` the step keeps
    its gradients in ``teacher``; otherwise it applies the teacher's."""
    import chip_smoke

    batch = chip_smoke.train_batches(cfg, 1, 2, seed=100 + seed)[0]
    in_ref, fakes = [False], []

    def hook(sub, by_net):
        in_ref[0] = sub == "G/latent"
        if teach:
            teacher[sub] = {net: [g.detach().clone() for g in gs] for net, gs in by_net.items()}
            return None
        return teacher[sub]

    def capture(module, args, out):
        if in_ref[0] and len(fakes) < 2:
            fakes.append(out.detach().float())

    state, frozen, step = chip_smoke.build_trainer(cfg, dev, grad_hook=hook, seed=seed)
    handle = state.nets["generator"].register_forward_hook(capture)
    step(state, frozen, batch)
    handle.remove()
    return fakes


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_ref_ds_gap_is_rounding_not_a_kernel(dev, seed):
    """ROADMAP.md section 1's closed G/ref_ds item, settled as rounding: at
    the 64^2 train step (B = 2) the bf16 run with the four kernels puts
    G/ref's two fakes no farther from the f32 run's than 1.5x the bf16
    run with their plain versions does.  Every run applies the plain
    run's gradients, so the G/ref sub-step starts from the same weights
    in all."""
    teacher = {}
    with pytest.MonkeyPatch.context() as mp:
        _plain_kernels(mp)
        plain = _ref_fakes(dev, _small_train_cfg("bfloat16"), seed, teacher, teach=True)
    f32 = _ref_fakes(dev, _small_train_cfg("float32"), seed, teacher, teach=False)
    kernels = _ref_fakes(dev, _small_train_cfg("bfloat16"), seed, teacher, teach=False)
    assert len(plain) == len(f32) == len(kernels) == 2
    for i, want in enumerate(f32):
        dist = {run: float((fakes[i] - want).abs().max() / want.abs().max())
                for run, fakes in (("plain", plain), ("kernels", kernels))}
        assert dist["kernels"] <= 1.5 * dist["plain"], (i, dist)


# ---------------------------------------------------------------------------
# Evaluation and alignment (metrics/eval_gan.py, models/align.py).
# ---------------------------------------------------------------------------


def test_align_pad_and_warp_on_the_card_match_cpu(dev):
    """The aligner's mirror-pad, blur and LANCZOS4 warp on the card against
    the CPU on the same image and matrices (a similarity whose window runs
    partly off the image): within 1e-2 on the 0-255 scale."""
    from ppvision_tpu_torch.models.align import pad_mirror, warp_lanczos4

    rng = np.random.default_rng(12)
    x = torch.from_numpy((rng.random((2, 256, 256, 3)) * 255).astype(np.float32))
    a, t = 0.25, (140.0, -60.0)
    mats = np.stack([np.array([[np.cos(a), -np.sin(a), t[0]], [np.sin(a), np.cos(a), t[1]], [0, 0, 1]])] * 2)
    want = warp_lanczos4(pad_mirror(x), mats, (256, 256))
    got = warp_lanczos4(pad_mirror(x.to(dev)), mats, (256, 256)).cpu()
    assert float((got - want).abs().max()) <= 1e-2
    assert 0.05 < float((want == 0).float().mean()) < 0.95


def test_calculate_metrics_on_the_card_matches_cpu(dev, monkeypatch, tmp_path):
    """``calculate_metrics`` at a 64^2 f32 configuration (max_conv_dim 64,
    style 16, latent 8, FAN at 64, camera n = 64; 2 domains x 4 images,
    batch 4, ``num_outs`` 3, seeded random nets and metric nets) on the
    card and on the CPU, in both modes: every LPIPS and FaceIDcos value
    within 1e-3 (``tests/test_torch_deid.py``'s f32 bound).  The full-size
    InceptionV3 would take the CPU most of a minute a run and a 2048^2
    ``sqrtm`` a FID, so ``collect_activations`` gives each image's channel
    means (the fakes' 299^2 resize and normalization still run) and
    ``fid_from_activations`` the squared distance of the means; Inception
    itself is held by ``test_metric_nets_on_the_card_match_cpu``."""
    import chip_smoke
    from ppvision_tpu_torch.config import CameraConfig, FaceDeIdConfig, ModelConfig
    from ppvision_tpu_torch.deid import build_deid
    from ppvision_tpu_torch.metrics import eval_gan

    cfg = FaceDeIdConfig(model=ModelConfig(img_size=64, style_dim=16, latent_dim=8, max_conv_dim=64,
                                           fan_input_size=64, compute_dtype="float32"), camera=CameraConfig(n=64))
    root = str(tmp_path)
    chip_smoke.write_face_folders(root, 62, (64, 64), n=4)
    monkeypatch.setattr(eval_gan, "collect_activations", lambda model, batches: np.concatenate(
        [torch.as_tensor(b).float().mean(dim=(1, 2)).cpu().numpy() for b in batches]))
    monkeypatch.setattr(eval_gan, "fid_from_activations",
                        lambda real, fake: float(np.sum((real.mean(0) - fake.mean(0)) ** 2)))
    res = {}
    with chip_smoke.array_io():
        for d in ("cuda", "cpu"):
            bundle = build_deid(0, cfg, d)
            for mode in ("latent", "reference"):
                res[d, mode] = eval_gan.calculate_metrics(bundle, root, mode=mode, num_outs=3, batch_size=4,
                                                          allow_random_metrics=True)
    for mode in ("latent", "reference"):
        want = res["cpu", mode]
        assert set(res["cuda", mode]) == set(want)
        errs = {k: abs(v - want[k]) for k, v in res["cuda", mode].items() if not k.startswith("FID")}
        assert errs and max(errs.values()) <= 1e-3, errs


def test_metric_nets_on_the_card_match_cpu(dev, monkeypatch):
    """InceptionV3 (4 x 299^2), IResNet-50 (4 x 112^2) and LPIPS's AlexNet
    features (4 x 256^2) at full size with seeded random weights, on the
    card and on the CPU in f32 (TF32 off, so the card computes true f32):
    the largest difference within 1e-3 of the largest output."""
    from ppvision_tpu_torch.metrics.face_id import IResNet
    from ppvision_tpu_torch.metrics.fid import InceptionV3
    from ppvision_tpu_torch.metrics.lpips import LPIPS
    from ppvision_tpu_torch.models.stargan import init_params_

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rng = np.random.default_rng(63)
    lpips = LPIPS()
    init_params_(lpips.alexnet, 0, gain=1.0)
    nets = {"inception": (init_params_(InceptionV3(), 1, gain=1.0), 299),
            "iresnet50": (init_params_(IResNet(), 2, gain=1.0), 112),
            "alexnet": (lpips, 256)}
    errs = {}
    with torch.no_grad():
        for name, (net, size) in nets.items():
            x = torch.from_numpy(rng.standard_normal((4, size, size, 3)).astype(np.float32))
            fn = (lambda m, v: m.features(v)) if name == "alexnet" else (lambda m, v: [m(v)])
            want = fn(net.eval(), x)
            got = fn(net.to(dev), x.to(dev))
            errs[name] = max(float((g.cpu() - w).abs().max()) / (float(w.abs().max()) + 1e-12)
                             for g, w in zip(got, want))
    assert all(v <= 1e-3 for v in errs.values()), errs


def test_int8_decode_passes_its_quality_gates(dev):
    """``chip_smoke.int8_gates`` (``tests/test_quant.py``'s SSIM > 0.9 and
    face-ID cosine >= 0.98) on the exact and int8 outputs of a 64^2 de-id
    bundle (max_conv_dim 64) on the card, B = 8, R = 2."""
    import dataclasses

    import chip_smoke
    from ppvision_tpu_torch.config import CameraConfig, FaceDeIdConfig, ModelConfig
    from ppvision_tpu_torch.deid import build_deid, deid_multi_style

    cfg = FaceDeIdConfig(model=ModelConfig(img_size=64, style_dim=16, latent_dim=8, max_conv_dim=64),
                         camera=CameraConfig(n=32))
    qcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, quant_decode=True))
    rng = np.random.default_rng(13)
    xs = torch.from_numpy(rng.random((8, 64, 64, 3), dtype=np.float32))
    xr = torch.from_numpy(rng.random((2, 64, 64, 3), dtype=np.float32))
    yr = torch.zeros(2, dtype=torch.long)
    ye = deid_multi_style(build_deid(0, cfg, device="cuda"), xs, xr, yr)
    yq = deid_multi_style(build_deid(0, qcfg, device="cuda"), xs, xr, yr)
    gates = chip_smoke.int8_gates(torch, ye, yq)
    assert gates["ssim"] > 0.9 and gates["cos"] >= 0.98


CAPTION_CARD_CPU_TOL = 1e-5  # f32 metrics and beam scores, relative, card against CPU (TF32 off)
# The f32 step's applied gradients and new BN statistics, relative norm,
# card against CPU.  The encoder's is loose: at this width its layer3-4
# BNs normalize 16-256 values a channel, their input gradients cancel, and
# the card's BN backward accumulates in f32 where the CPU's accumulates
# in f64.  The f64 step holds the card's backward to CAPTION_F64_TOL.
CAPTION_GRAD_TOL = {"camera": 1e-3, "encoder": 1e-2, "decoder": 1e-4, "encoder_bn_stats": 1e-5}
CAPTION_F64_TOL = 1e-10  # the f64 step: metrics relative, gradients and BN statistics relative norm


def test_caption_train_step_and_beam_search_on_the_card_match_cpu(dev, monkeypatch):
    """One train step at a small width (ResNet stages (1, 1, 1, 1), widths
    64, 4x4 features, 64^2 images, the lens at ``LensSpec(128, 64, 16)``
    without height noise, dropout 0, ``camera_lr`` 1e-2, B = 4, a
    200-entry word map) on the card (TF32 off) and on the CPU from the
    same seeded weights and batch, in f32 and in f64: the metrics, each
    module's applied gradient and the encoder's new BN statistics within
    ``CAPTION_CARD_CPU_TOL`` and ``CAPTION_GRAD_TOL`` in f32 and
    ``CAPTION_F64_TOL`` in f64.  The applied gradient is read from Adam:
    after its first step its ``exp_avg`` is (1 - beta1) times it.  Then
    beam search (beam 5, 20 steps) on the card's updated f32 weights and
    on a CPU copy of them: the tokens identical, the scores within
    ``CAPTION_CARD_CPU_TOL``."""
    import copy

    import chip_smoke
    from ppvision_tpu_torch.config import CaptionConfig
    from ppvision_tpu_torch.models.captioner import beam_search_batch
    from ppvision_tpu_torch.optics.lens import LensSpec, make_lens_constants
    from ppvision_tpu_torch.train.caption import init_caption, make_caption_train_step, make_optimizers

    cfg = CaptionConfig(emb_dim=64, attention_dim=64, decoder_dim=64, encoded_image_size=4, dropout=0.0,
                        camera_lr=1e-2)
    spec = LensSpec(wave_res=128, patch_size=64, zernike_terms=16, height_tolerance=0.0)
    word_map = chip_smoke.caption_word_map(200)
    rng = np.random.default_rng(71)
    caps, lens = chip_smoke.caption_tokens(rng, 4, word_map, length=14)
    batch = dict(images=torch.from_numpy(chip_smoke.smooth_images(4, 64, 72)), captions=torch.from_numpy(caps),
                 caption_lengths=torch.from_numpy(lens))

    def applied(opt) -> torch.Tensor:
        beta1 = opt.param_groups[0]["betas"][0]
        return torch.cat([opt.state[p]["exp_avg"].double().flatten().cpu() / (1 - beta1)
                          for p in opt.param_groups[0]["params"]])

    def one_step(d: str, dtype):
        state = init_caption(0, cfg, len(word_map) + 1, spec, encoder_stages=(1, 1, 1, 1), device=d)
        for m in (state.camera, state.encoder, state.decoder):
            m.to(dtype)
        state.opt_camera, state.opt_encoder, state.opt_decoder = make_optimizers(
            cfg, state.camera, state.encoder, state.decoder)
        step = make_caption_train_step(cfg, spec, make_lens_constants(spec, dtype=dtype, device=d))
        b = {k: v.to(d, dtype) if v.is_floating_point() else v.to(d) for k, v in batch.items()}
        metrics = step(state, b, torch.Generator(device=d).manual_seed(0))
        got = {m: applied(getattr(state, f"opt_{m}")) for m in ("camera", "encoder", "decoder")}
        got["encoder_bn_stats"] = torch.cat([v.double().flatten().cpu() for k, v in state.encoder.state_dict().items()
                                             if k.endswith(("running_mean", "running_var"))])
        return {k: float(v) for k, v in metrics.items()}, got, state

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    for dtype in (torch.float32, torch.float64):
        (mc, gc, _), (mg, gg, card_state) = (one_step(d, dtype) for d in ("cpu", "cuda"))
        rel = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-6) for k in mc}
        grad_rel = {m: float((gg[m] - gc[m]).norm() / gc[m].norm()) for m in gc}
        assert set(grad_rel) == set(CAPTION_GRAD_TOL)
        tol = CAPTION_F64_TOL if dtype == torch.float64 else CAPTION_CARD_CPU_TOL
        grad_tol = dict.fromkeys(gc, CAPTION_F64_TOL) if dtype == torch.float64 else CAPTION_GRAD_TOL
        assert all(v <= tol for v in rel.values()), (dtype, rel)
        assert all(v <= grad_tol[m] for m, v in grad_rel.items()), (dtype, grad_rel)
        if dtype == torch.float32:
            f32_decoder = card_state.decoder
    feats = torch.from_numpy(np.random.default_rng(73).standard_normal((3, 4, 4, 2048), dtype=np.float32))
    cpu_dec = copy.deepcopy(f32_decoder).cpu()
    start, end = word_map["<start>"], word_map["<end>"]
    with torch.no_grad():
        bs_card = beam_search_batch(f32_decoder.eval(), feats.to(dev), start, end, 5, 20)
        bs_cpu = beam_search_batch(cpu_dec.eval(), feats, start, end, 5, 20)
    assert torch.equal(bs_card[0].cpu(), bs_cpu[0])
    score_rel = float(((bs_card[1].cpu() - bs_cpu[1]).abs() / bs_cpu[1].abs().clamp_min(1e-6)).max())
    assert score_rel <= CAPTION_CARD_CPU_TOL, score_rel
