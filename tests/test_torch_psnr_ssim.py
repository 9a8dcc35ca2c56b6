"""The port's SSIM and PSNR (metrics/psnr_ssim.py) against the JAX
package's on the same seeded NHWC batches: the window bit for bit, the
separable f32 path to rtol 1e-6, the f64 path (the 2-D outer-product
window) to 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppvision_tpu.metrics import psnr_ssim as jm
from ppvision_tpu_torch.metrics import psnr_ssim as tm


def _pair(seed: int, dtype, shape=(2, 24, 20, 3)):
    rng = np.random.default_rng(seed)
    a = rng.random(shape)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0, 1)
    return a.astype(dtype), b.astype(dtype)


def test_window_is_bit_identical():
    for size, sigma in ((11, 1.5), (7, 1.0)):
        assert np.array_equal(tm.gaussian_window(size, sigma), jm.gaussian_window(size, sigma))


@pytest.mark.parametrize("size_average", [True, False])
def test_f32_matches_jax(size_average):
    a, b = _pair(0, np.float32)
    want = np.asarray(jm.ssim(jnp.asarray(a), jnp.asarray(b), size_average=size_average))
    got = tm.ssim(torch.from_numpy(a), torch.from_numpy(b), size_average=size_average).numpy()
    # f32 conv sums in another order; measured ~1e-7 relative.
    np.testing.assert_allclose(got, want, rtol=1e-6)
    want = float(jm.psnr(jnp.asarray(a), jnp.asarray(b)))
    got = float(tm.psnr(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_f64_two_d_window_matches_jax():
    a, b = _pair(1, np.float64)
    with jax.enable_x64(True):
        want = np.asarray(jm.ssim(jnp.asarray(a), jnp.asarray(b), size_average=False))
        want_psnr = float(jm.psnr(jnp.asarray(a), jnp.asarray(b)))
    got = tm.ssim(torch.from_numpy(a), torch.from_numpy(b), size_average=False).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert abs(float(tm.psnr(torch.from_numpy(a), torch.from_numpy(b))) - want_psnr) <= 1e-12 * want_psnr


def test_identical_images():
    a, _ = _pair(2, np.float32)
    t = torch.from_numpy(a)
    assert abs(float(tm.ssim(t, t)) - 1.0) < 1e-6
    assert float(tm.psnr(t, t)) == pytest.approx(120.0)
