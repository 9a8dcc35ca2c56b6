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
from ppvision_tpu_torch.ops.instats import _launch, _moments_ref, instance_moments
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


def test_raft_matmul_conv_matches_cudnn(dev):
    from ppvision_tpu_torch.models.raft import _MatmulConv2d

    conv = _MatmulConv2d(256, 192, 3, padding=1).to(dev)
    x = _randn(np.random.default_rng(8), (3, 256, 10, 12)).to(dev)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want = torch.nn.functional.conv2d(x, conv.weight, conv.bias, padding=1)
        err = float((conv(x) - want).abs().max())
    # True f32 on both sides: sums of 2304 products in another order.
    assert err <= 1e-5 * float(want.abs().max()), err


def test_raft_alternate_matches_dense_on_the_card(dev):
    from ppvision_tpu_torch.models.raft import build_raft

    alt = build_raft(0, dev, iters=3, corr_levels=3, alternate_corr=True)
    dense = build_raft(0, dev, iters=3, corr_levels=3)
    rng = np.random.default_rng(7)
    im1 = torch.from_numpy(rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)).to(dev)
    im2 = torch.roll(im1, 2, dims=2)
    before = local_corr.launches
    with torch.no_grad():
        a, d = alt(im1, im2), dense(im1, im2)
    assert local_corr.launches == before + 3 * 3  # one launch a level a step
    scale = float(d.abs().max()) + 1e-6
    assert torch.allclose(a, d, atol=2e-4 * scale, rtol=1e-4)


def test_deid_path_runs_every_kernel_and_matches_cpu(dev):
    from ppvision_tpu_torch.config import CameraConfig, FaceDeIdConfig, ModelConfig
    from ppvision_tpu_torch.deid import build_deid, deid_multi_style
    from ppvision_tpu_torch.ops import DEID_KERNELS, KERNELS

    rng = np.random.default_rng(4)
    xs = torch.from_numpy(rng.random((2, 64, 64, 3), dtype=np.float32))
    xr = torch.from_numpy(rng.random((2, 64, 64, 3), dtype=np.float32))
    yr = torch.tensor([0, 1])
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = FaceDeIdConfig(
            model=ModelConfig(img_size=64, style_dim=16, latent_dim=8, max_conv_dim=64,
                              compute_dtype=dtype),
            camera=CameraConfig(n=32),
        )
        for d in ("cuda", "cpu"):
            for fn in KERNELS.values():
                fn.launches = 0
            out[dtype, d] = deid_multi_style(build_deid(0, cfg, device=d), xs, xr, yr).cpu().numpy()
            if d == "cuda" and dtype == "bfloat16":
                assert all(KERNELS[k].launches > 0 for k in DEID_KERNELS)
    ref = out["float32", "cpu"]
    assert np.abs(out["float32", "cuda"] - ref).max() <= 2e-3 * max(1.0, np.abs(ref).max())
    # bf16: no further from the CPU bf16 run than that run is from f32.
    gap = np.abs(out["bfloat16", "cpu"] - ref).max()
    assert np.abs(out["bfloat16", "cuda"] - out["bfloat16", "cpu"]).max() <= 1.5 * gap + 1e-3


# ---------------------------------------------------------------------------
# Gradients through the kernels (the training slice).  Each kernel's
# backward is its plain version's VJP; conv3x3's is differentiable again.
# ---------------------------------------------------------------------------


def _rel(got, want) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max()) / (float(want.abs().max()) + 1e-12)


@pytest.mark.parametrize("shape", [(4, 256, 256, 64, 64), (4, 64, 64, 128, 256), (4, 8, 8, 512, 512),
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


@pytest.mark.parametrize("shape", [(4, 256, 256, 64), (4, 32, 32, 512), (4, 8, 8, 512)])
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


def test_train_step_runs_every_kernel_and_matches_cpu(dev):
    """One train step at 64^2 on the card and on the CPU, same weights and
    batch.  In f32 (TF32 off) every loss within 2e-2 and each gradient at
    cosine >= 0.98; in bf16 the four de-id kernels launch and every loss
    is finite.  Each run applies the CPU f32 run's gradients, so each
    sub-step starts from the same weights everywhere (Adam's first step
    turns a flipped near-zero gradient sign into a 2 lr move of its
    weight).  chip_smoke.py holds the bf16 step to the CPU's own
    bf16-vs-f32 gap."""
    from ppvision_tpu_torch.config import CameraConfig, FaceDeIdConfig, ModelConfig, TrainConfig
    from ppvision_tpu_torch.ops import DEID_KERNELS, KERNELS
    from ppvision_tpu_torch.train.gan import init_gan, make_train_step
    from ppvision_tpu_torch.train.pretrained import build_aux_losses, load_frozen_nets

    rng = np.random.default_rng(10)
    batch = dict(x_src=rng.random((2, 64, 64, 3), dtype=np.float32), x_ref=rng.random((2, 64, 64, 3), dtype=np.float32),
                 x_ref2=rng.random((2, 64, 64, 3), dtype=np.float32), y_src=np.array([0, 1]), y_ref=np.array([1, 0]),
                 z_trg=rng.standard_normal((2, 16), dtype=np.float32),
                 z_trg2=rng.standard_normal((2, 16), dtype=np.float32))
    out, teacher = {}, {}
    for dtype, d in (("float32", "cpu"), ("float32", "cuda"), ("bfloat16", "cuda")):
        cfg = FaceDeIdConfig(model=ModelConfig(img_size=64, max_conv_dim=64, fan_input_size=64, compute_dtype=dtype),
                             camera=CameraConfig(n=64), train=TrainConfig(flow_iters=2))
        grads = {}

        def hook(sub, by_net):
            for net, gs in by_net.items():
                grads[sub, net] = torch.cat([g.detach().double().flatten().cpu() for g in gs])
            if sub not in teacher:
                teacher[sub] = {net: [g.detach().clone() for g in gs] for net, gs in by_net.items()}
                return None
            return {net: [g.to(gs[0].device) for g in teacher[sub][net]] for net, gs in by_net.items()}

        for fn in KERNELS.values():
            fn.launches = 0
        step = make_train_step(cfg, *build_aux_losses(cfg, 0, d), grad_hook=hook)
        losses = {k: float(v) for k, v in step(init_gan(0, cfg, d), load_frozen_nets(cfg, 0, d), batch).items()}
        out[dtype, d] = losses, grads
        assert all(np.isfinite(v) for v in losses.values())
        if dtype == "bfloat16":
            assert all(KERNELS[k].launches > 0 for k in DEID_KERNELS)
    (lc, gc), (lg, gg) = out["float32", "cpu"], out["float32", "cuda"]
    for k in lc:
        assert abs(lg[k] - lc[k]) <= 2e-2 * max(abs(lc[k]), 1e-6), k
    for key in gc:
        cos = float(gg[key] @ gc[key] / (gg[key].norm() * gc[key].norm() + 1e-30))
        assert cos >= 0.98, (key, cos)


# (B, H, C, O, up) of the int8 decode's products: de-id at 128^2 (B = 8),
# the 256^2 generator at B = 4, and odd maps (up: a K4 phase with odd H).
INT8_SHAPES = [
    (8, 8, 512, 512, False), (8, 8, 512, 512, True), (8, 16, 512, 512, False), (8, 16, 512, 512, True),
    (8, 32, 512, 512, False), (8, 32, 512, 256, True), (8, 64, 256, 256, False), (8, 64, 256, 128, True),
    (8, 128, 128, 128, False), (4, 128, 128, 64, True), (4, 256, 64, 64, False), (2, 7, 16, 24, True),
    (3, 5, 8, 8, False),
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


def test_bf16_ref_ds_gap_is_rounding_not_a_kernel(dev):
    """ROADMAP.md section 3's G/ref_ds item, settled as rounding: at the
    64^2 train step (B = 2) the bf16 run with the four kernels puts G/ref's
    fakes no farther from the f32 run than 1.5x the run with their plain
    versions does, from the same weights (``chip_smoke.ref_ds_study`` at
    two of its seeds)."""
    import chip_smoke
    from ppvision_tpu_torch.ops import KERNELS

    mp = pytest.MonkeyPatch()
    mp.setattr(chip_smoke, "STUDY_SEEDS", (0, 1))
    mp.setattr(chip_smoke, "BF16_RUNS", ("plain", "kernels"))
    mp.setattr(chip_smoke, "STUDY_RUNS", ("plain", "f32", "kernels"))
    try:
        rows = chip_smoke.ref_ds_study(torch, KERNELS)
    finally:
        mp.undo()
    for seed in (0, 1):
        for key in ("x_fake_vs_f32", "x_fake2_vs_f32"):
            assert rows[seed, "kernels"][key] <= 1.5 * rows[seed, "plain"][key], (seed, key)


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


def test_calculate_metrics_on_the_card_matches_cpu(dev):
    """``chip_smoke.eval_gpu_vs_cpu``: the 64^2 f32 evaluation on the card
    and on the CPU, every LPIPS and FaceIDcos value within 1e-3."""
    import chip_smoke

    errs = chip_smoke.eval_gpu_vs_cpu(torch)
    assert max(v for k, v in errs.items() if not k.startswith("FID")) <= chip_smoke.EVAL_CARD_CPU_TOL


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


def test_caption_train_step_and_beam_search_on_the_card_match_cpu(dev):
    """``chip_smoke.caption_gpu_vs_cpu``: one small-width caption train
    step on the card and on the CPU from the same weights and batch, in
    f32 and f64 (the metrics, each module's applied gradient and the new
    BN statistics within the script's limits: ``CAPTION_F64_TOL`` in
    f64), and beam search on the same weights on both: the tokens
    identical."""
    import chip_smoke

    out = chip_smoke.caption_gpu_vs_cpu(torch)
    assert out["same_tokens"] and out["score_rel"] <= chip_smoke.CAPTION_CARD_CPU_TOL
    assert max(out["f32"]["rel"].values()) <= chip_smoke.CAPTION_CARD_CPU_TOL
    assert all(out["f32"]["grad_rel"][m] <= tol for m, tol in chip_smoke.CAPTION_GRAD_TOL.items())
    assert set(out["f64"]["grad_rel"]) == set(chip_smoke.CAPTION_GRAD_TOL)
    assert max(*out["f64"]["rel"].values(), *out["f64"]["grad_rel"].values()) <= chip_smoke.CAPTION_F64_TOL
