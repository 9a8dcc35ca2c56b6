"""The port's sampling and video helpers (``sample.py``) against the JAX
package's on the TINY float32 configuration of ``tests/torch_parity.py``,
with the same parameters and numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppvision_tpu import sample as jsample
from ppvision_tpu.deid import _privacy_front as jax_privacy_front
from ppvision_tpu_torch import sample as tsample

from .torch_parity import TINY, jax_bundle, torch_bundle

N = TINY["img_size"]
# f32 on both sides: the de-id path matches the JAX package to <= 1e-3
# (tests/test_torch_deid.py); the video frames are min-max normalized
# copies of such outputs, so they are held to the same bound.
TOL = 1e-3


@pytest.fixture(scope="module")
def bundles():
    jb = jax_bundle("float32")
    return jb, torch_bundle(jb, "float32")


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    xs = rng.random((2, N, N, 3)).astype(np.float32)
    xr = rng.random((2, N, N, 3)).astype(np.float32)
    return xs, xr


def test_video_ref_frames_match_jax(bundles, images, tmp_path):
    jb, tb = bundles
    xs, xr = images
    yr = np.array([1, 1], np.int32)  # two references of one domain: one segment
    want = jsample.video_ref(jb, jb.params, jnp.asarray(xs), jnp.asarray(xr), jnp.asarray(yr), str(tmp_path / "j.mp4"))
    got = tsample.video_ref(tb, *map(torch.from_numpy, (xs, xr)), torch.from_numpy(yr).long(), str(tmp_path / "t.mp4"))
    t = len(jsample.get_alphas())
    assert got.shape == want.shape == (t + 10, 2 * N, N + 32 + 2 * N, 3)
    np.testing.assert_array_equal(tsample.get_alphas(), jsample.get_alphas())
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="same domain"):
        tsample.video_ref(tb, *map(torch.from_numpy, (xs, xr)), torch.tensor([0, 1]), str(tmp_path / "none.mp4"))


def test_interpolate_frames_match_jax(bundles, images):
    """The multi-style generator call on the same privacy image, masks
    and style pair (JAX's own privacy front feeds both sides)."""
    jb, tb = bundles
    xs, _ = images
    x_priv, masks = jax.jit(lambda p, x: jax_privacy_front(jb, p, x))(jb.params, jnp.asarray(xs))
    rng = np.random.default_rng(1)
    sp, sn = (rng.standard_normal((1, TINY["style_dim"])).astype(np.float32) for _ in range(2))
    alphas = jsample.get_alphas()[::4]
    want = np.asarray(jsample._interpolate_frames(jb, jb.params, x_priv, masks, jnp.asarray(sp), jnp.asarray(sn), alphas))
    tmasks = tuple(torch.from_numpy(np.array(m)).permute(0, 3, 1, 2) for m in masks)
    got = tsample._interpolate_frames(
        tb, torch.from_numpy(np.array(x_priv)), tmasks, torch.from_numpy(sp), torch.from_numpy(sn), alphas
    ).numpy()
    assert got.shape == want.shape == (len(alphas), 2, N, N, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_translate_using_reference_matches_jax(bundles, images):
    jb, tb = bundles
    xs, xr = images
    yr = np.array([0, 1], np.int32)
    want = jsample.translate_using_reference(jb, jb.params, jnp.asarray(xs), jnp.asarray(xr), jnp.asarray(yr))
    got = tsample.translate_using_reference(tb, *map(torch.from_numpy, (xs, xr, yr)))
    assert got.shape == want.shape == (2, 2, N, N, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_mean_style_matches_jax_on_the_same_latents(bundles):
    """JAX draws its latents from jax.random and the port from a
    torch.Generator; given JAX's latents, the port's mean is JAX's."""
    jb, tb = bundles
    num, seed = 2048, 3
    want = np.asarray(jsample.mean_style(jb, jb.params, 1, num=num, seed=seed))
    z = np.array(jax.random.normal(jax.random.key(seed), (num, TINY["latent_dim"])))
    got = tsample.mean_style(tb, 1, z=torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (1, TINY["style_dim"])
    # A mean of 2048 f32 MLP outputs, summed in another order.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    drawn = tsample.mean_style(tb, 1, num=num, seed=seed)
    assert torch.equal(drawn, tsample.mean_style(tb, 1, num=num, seed=seed))


def test_dice_coefficient_batch_matches_jax():
    rng = np.random.default_rng(2)
    a = (rng.random((4, 16, 16, 1)) > 0.5).astype(np.float32)
    b = (rng.random((4, 16, 16, 1)) > 0.4).astype(np.float32)
    b[0] = a[0]
    want = np.asarray(jsample.dice_coefficient_batch(jnp.asarray(a), jnp.asarray(b)))
    got = tsample.dice_coefficient_batch(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == pytest.approx(1.0)
