"""The port's RAFT (both correlation modes), its flow loss, the video
flow-consistency score and the sampling helpers against the JAX
package's ``models/raft.py`` and ``metrics/temporal.py``, on the same
parameters (carried over by ``utils/jax_params.raft_state_dict``) and
the same numpy inputs, in f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppvision_tpu.metrics import temporal as jtemporal
from ppvision_tpu.models import raft as jraft
from ppvision_tpu_torch.metrics.temporal import flow_consistency
from ppvision_tpu_torch.models import raft as traft
from ppvision_tpu_torch.utils.jax_params import raft_state_dict

from .torch_parity import numpy_tree

B, SIZE, LEVELS, RADIUS, ITERS = 2, 64, 3, 4, 3
# RAFT(alternate_corr) against the dense path at the same weights: the JAX
# package's own tolerance (tests/test_raft.py), relative to the flow scale.
# The port against JAX is held to the same bound: f32 on both sides,
# conv and dot sums in another order, through ITERS refinement steps.
ATOL_REL, RTOL = 2e-4, 1e-4


@pytest.fixture(scope="module")
def setup():
    model = jraft.RAFT(iters=ITERS, corr_levels=LEVELS, corr_radius=RADIUS)
    rng = np.random.default_rng(0)
    im1 = rng.uniform(0, 255, (B, SIZE, SIZE, 3)).astype(np.float32)
    # The second frame: the first shifted 2 px right, plus noise.
    im2 = np.clip(np.roll(im1, 2, axis=2) + rng.normal(0, 8, im1.shape), 0, 255).astype(np.float32)
    init = jax.jit(lambda k, a, b: model.init(k, a, b, iters=1))
    params = init(jax.random.key(3), jnp.asarray(im1), jnp.asarray(im2))["params"]
    port = {}
    for alt in (False, True):
        m = traft.build_raft(device="cpu", iters=ITERS, corr_levels=LEVELS, corr_radius=RADIUS, alternate_corr=alt)
        m.load_state_dict(raft_state_dict(numpy_tree(params)), strict=True)
        port[alt] = m
    return model, params, port, im1, im2


def _close(got, want):
    scale = float(np.abs(want).max()) + 1e-6
    np.testing.assert_allclose(got, want, atol=ATOL_REL * scale, rtol=RTOL)


@pytest.mark.parametrize("alt", [False, True], ids=["dense", "alternate"])
def test_raft_matches_jax(setup, alt):
    model, params, port, im1, im2 = setup
    jmodel = jraft.RAFT(iters=ITERS, corr_levels=LEVELS, corr_radius=RADIUS, alternate_corr=alt)
    want = np.asarray(jax.jit(lambda p, a, b: jmodel.apply({"params": p}, a, b))(params, im1, im2))
    with torch.no_grad():
        got = port[alt](torch.from_numpy(im1), torch.from_numpy(im2)).numpy()
    assert got.shape == want.shape == (B, SIZE, SIZE, 2)
    assert np.abs(want).max() > 0.1  # the flow is not trivially zero
    _close(got, want)


def test_raft_flow_loss_and_input_gradient_match_jax(setup):
    """Value and d loss / d frame2 (the generator-fake slot) through the
    unrolled refinement, iters = 2, the alternate path's backward
    included (local_corr's replay through its plain version)."""
    model, params, port, im1, im2 = setup
    jmodel = jraft.RAFT(iters=2, corr_levels=LEVELS, corr_radius=RADIUS, alternate_corr=True)
    loss_j, g_j = jax.value_and_grad(
        lambda b: jraft.raft_flow_loss(jmodel, params, jnp.asarray(im1), b, iters=2)
    )(jnp.asarray(im2))
    t2 = torch.from_numpy(im2).requires_grad_()
    loss_t = traft.raft_flow_loss(port[True], torch.from_numpy(im1), t2, iters=2)
    loss_t.backward()
    assert abs(float(loss_t.detach()) - float(loss_j)) <= 1e-4 * max(1.0, abs(float(loss_j)))
    g_j = np.asarray(g_j)
    # Gradients through two refinement steps: same scale-relative bound.
    assert np.abs(t2.grad.numpy() - g_j).max() <= 1e-3 * np.abs(g_j).max()


def test_flow_consistency_matches_jax(setup):
    model, params, port, im1, _ = setup
    rng = np.random.default_rng(1)
    src = np.stack([np.roll(im1[0], t, axis=1) for t in range(3)]) / 255.0
    fake = np.clip(src + rng.normal(0, 0.05, src.shape), 0, 1).astype(np.float32)
    src = src.astype(np.float32)
    want = jtemporal.flow_consistency(model, params, jnp.asarray(src), jnp.asarray(fake), iters=2)
    got = flow_consistency(port[True], torch.from_numpy(src), torch.from_numpy(fake), iters=2)
    assert np.isfinite(got) and got > 0
    # A mean of per-pixel end-point errors between two flows.
    assert abs(got - want) <= 1e-3 * max(1.0, abs(want)), (got, want)


def test_bilinear_sampler_and_coords_grid_match_jax():
    rng = np.random.default_rng(2)
    img = rng.standard_normal((2, 5, 6, 3)).astype(np.float32)
    coords = rng.uniform(-2, 8, (2, 4, 7, 2)).astype(np.float32)
    coords[0, 0, 0] = (1.5, 2.25)
    want = np.asarray(jraft.bilinear_sampler(jnp.asarray(img), jnp.asarray(coords)))
    got = traft.bilinear_sampler(torch.from_numpy(img), torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    oob = traft.bilinear_sampler(torch.from_numpy(img), torch.full((2, 1, 1, 2), -3.0))
    np.testing.assert_array_equal(oob.numpy(), 0.0)
    np.testing.assert_array_equal(traft.coords_grid(2, 3, 4).numpy(), np.asarray(jraft.coords_grid(2, 3, 4)))


def test_convex_upsample_and_upflow8_match_jax():
    rng = np.random.default_rng(3)
    flow = rng.standard_normal((2, 3, 5, 2)).astype(np.float32)
    mask = rng.standard_normal((2, 3, 5, 576)).astype(np.float32)
    want = np.asarray(jraft.convex_upsample(jnp.asarray(flow), jnp.asarray(mask)))
    got = traft.convex_upsample(torch.from_numpy(flow), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (2, 24, 40, 2)
    # A softmax-weighted sum of 9 values of |8 x flow| <= ~30.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    want8 = np.asarray(jraft.upflow8(jnp.asarray(flow)))
    np.testing.assert_allclose(traft.upflow8(torch.from_numpy(flow)).numpy(), want8, rtol=0, atol=1e-5)


def test_dense_pyramid_lookup_matches_jax():
    rng = np.random.default_rng(4)
    f1 = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    f2 = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    coords = (np.asarray(jraft.coords_grid(2, 8, 8)) + rng.uniform(-3, 3, (2, 8, 8, 2))).astype(np.float32)
    jp = jraft.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 3)
    want = np.asarray(jraft.lookup_corr_pyramid(jp, jnp.asarray(coords), 2))
    tp = traft.build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), 3)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[..., 0], rtol=0, atol=1e-5)
    got = traft.lookup_corr_pyramid(tp, torch.from_numpy(coords), 2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
