"""The port's windowed correlation (kernel 5's plain version, its
autograd backward and the per-level composition) against the JAX
package's ``ops/corr.py`` on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppvision_tpu.ops import corr as jcorr
from ppvision_tpu_torch.ops.corr import alternate_corr_lookup, local_corr, local_corr_ref, plan_corr

# Both sides are f32 dot products of C terms summed in another order, then
# the same four bilinear products: the error scale is a few f32 ulps of the
# largest |dot|, so 2e-6 of it (C <= 32 here; ~16 ulps).
REL = 2e-6


def _inputs(seed, b, h, w, c, h2, w2, spread):
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    f2 = rng.standard_normal((b, h2, w2, c)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack([xs * (w2 / w), ys * (h2 / h)], -1).astype(np.float32)
    coords = (grid + rng.uniform(-spread, spread, (b, h, w, 2))).astype(np.float32)
    return f1, f2, coords


def _port(f1, f2, coords, r):
    return local_corr_ref(torch.from_numpy(f1), torch.from_numpy(f2), torch.from_numpy(coords), r).numpy()


def _close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * scale)


@pytest.mark.parametrize(
    "case",
    [
        # (b, h, w, c, h2, w2, radius, spread): in range, H2 != H, wide
        # offsets that reach past every border (negative fractions included).
        (2, 6, 7, 8, 6, 7, 2, 1.5),
        (1, 5, 4, 16, 9, 3, 3, 6.0),
        (2, 4, 4, 4, 2, 2, 4, 3.0),
    ],
)
def test_local_corr_ref_matches_xla(case):
    b, h, w, c, h2, w2, r, spread = case
    f1, f2, coords = _inputs(len(case) + h2, b, h, w, c, h2, w2, spread)
    want = np.asarray(jcorr.local_corr_xla(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(coords), r))
    got = _port(f1, f2, coords, r)
    assert got.shape == want.shape == (b, h, w, (2 * r + 1) ** 2)
    _close(got, want)


def test_local_corr_ref_matches_xla_at_the_kernels_width():
    """C = 256 and r = 4, as RAFT runs the kernel, on a 4x4 map (level
    3's case: at most 16 of a query's 100 grid points in the map)."""
    f1, f2, coords = _inputs(9, 2, 4, 4, 256, 4, 4, 3.0)
    want = np.asarray(jcorr.local_corr_xla(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(coords), 4))
    _close(_port(f1, f2, coords, 4), want)


# (B, H*W, C, H2, W2, r) the kernel is planned for: the video path's four
# levels (B = 30 pairs at 256^2, B = 2 and 1 in RAFT's checks), RAFT at
# 64^2 and 128^2, and the card tests' shapes.
PLANNED = [
    *[(30, 1024, 256, 32 >> l, 32 >> l, 4) for l in range(4)],
    *[(2, 1024, 256, 32 >> l, 32 >> l, 4) for l in range(4)],
    *[(1, 256, 256, 16 >> l, 16 >> l, 4) for l in range(4)],
    *[(2, 64, 256, 8 >> l, 8 >> l, 4) for l in range(3)],
    (2, 4096, 256, 64, 64, 4), (4, 1024, 256, 16, 16, 4), (2, 256, 64, 16, 16, 0), (2, 256, 64, 16, 16, 1),
    (1, 144, 32, 12, 12, 16), (2, 63, 128, 9, 7, 16), (3, 256, 4, 8, 8, 4), (2, 256, 128, 16, 16, 4),
    (2, 256, 512, 16, 16, 4), (2, 120, 256, 3, 5, 4), (1, 64, 36, 2, 7, 3), (2, 65, 20, 6, 11, 2),
    (8, 4096, 512, 64, 64, 16), (1, 1, 4, 1, 1, 0),
]


@pytest.mark.parametrize("shape", PLANNED)
def test_plan_corr_fits_and_covers_every_query_once(shape):
    b, hw, c, h2, w2, r = shape
    plan = plan_corr(*shape)
    k1 = 2 * r + 2
    lanes = 8 * -(-k1 * k1 // 104)  # a quarter-warp for each 104 window points
    assert plan.smem <= 227 * 1024
    assert plan.qb * lanes <= plan.threads <= 1024 and plan.threads % 32 == 0
    assert 16 <= plan.cw <= max(16, -(-c // 16) * 16) and plan.cw & (plan.cw - 1) == 0
    pu = plan.cw // 4 + 1
    assert plan.cap >= pu + 7  # a tile holds at least one point of a row
    # The shared memory holds the header, two ring stages and the scores.
    assert 4 * (4 + 4 * plan.qb) + 32 * ((plan.qb + 1) * pu + plan.cap) <= plan.smem + 16
    assert 4 * (4 + 4 * plan.qb) + 4 * plan.qb * (k1 * k1 + 1) <= plan.smem + 16
    if plan.cw > 16:  # a channel step wider than 16 only where the whole map fits a stage
        assert plan.cap >= h2 * (w2 * pu + 7)
    seen = np.zeros(hw, int)
    for q0 in range(0, hw, plan.qb):  # the blocks of one image, grid.x = ceil(HW / qb)
        seen[q0:min(q0 + plan.qb, hw)] += 1
    assert (seen == 1).all() and -(-hw // plan.qb) * plan.qb < hw + plan.qb


def test_local_corr_ref_matches_pallas_interpret():
    """The JAX test's size (tests/test_raft.py): (1, 4, 8, 16), r = 3,
    plus an exact border coordinate, a negative fraction and far-out
    coords, which must be exactly zero."""
    f1, f2, coords = _inputs(2, 1, 4, 8, 16, 4, 8, 3.0)
    coords[0, 0, 0] = (0.0, 0.0)
    coords[0, 0, 1] = (-0.25, -3.75)
    coords[0, 1, 2] = (7.0, 3.0)
    want = np.asarray(jcorr.local_corr_pallas(*map(jnp.asarray, (f1, f2, coords)), radius=3, interpret=True))
    _close(_port(f1, f2, coords, 3), want)
    far = coords + 100.0
    np.testing.assert_array_equal(_port(f1, f2, far, 3), 0.0)
    np.testing.assert_array_equal(_port(f1, f2, -far, 3), 0.0)


def test_local_corr_cpu_wrapper_is_the_plain_version():
    f1, f2, coords = _inputs(3, 1, 3, 5, 8, 4, 6, 2.0)
    t = [torch.from_numpy(a) for a in (f1, f2, coords)]
    before = local_corr.launches
    np.testing.assert_array_equal(local_corr(*t, 2).numpy(), local_corr_ref(*t, 2).numpy())
    assert local_corr.launches == before  # nothing launched on the CPU


def test_alternate_corr_lookup_matches_jax_three_levels():
    f1, f2, coords = _inputs(4, 2, 8, 8, 16, 8, 8, 2.0)
    want = np.asarray(jcorr.alternate_corr_lookup(*map(jnp.asarray, (f1, f2, coords)), num_levels=3, radius=2))
    got = alternate_corr_lookup(*map(torch.from_numpy, (f1, f2, coords)), num_levels=3, radius=2).numpy()
    assert got.shape == want.shape == (2, 8, 8, 3 * 25)
    # Pooled fmap2 levels: the same f32 slice-form pool on both sides.
    _close(got, want)


def test_local_corr_backward_matches_jax_vjp():
    """The autograd backward (a replay through local_corr_ref) against
    jax.vjp of the JAX package's custom-VJP ``local_corr``."""
    f1, f2, coords = _inputs(5, 2, 4, 5, 8, 5, 4, 2.5)
    g = np.random.default_rng(6).standard_normal((2, 4, 5, 25)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jcorr.local_corr(a, b, c, 2), *map(jnp.asarray, (f1, f2, coords)))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    t = [torch.from_numpy(a).requires_grad_() for a in (f1, f2, coords)]
    local_corr(*t, 2).backward(torch.from_numpy(g))
    for name, got, ref in zip(("fmap1", "fmap2", "coords"), (x.grad.numpy() for x in t), want):
        # Sums of up to K^2 x 4 products per entry, in another order.
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale, err_msg=name)
