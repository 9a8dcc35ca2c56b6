"""Port kernel 1 (ops/fftconv.py) and optics/fourier.py against the JAX
package: the circular FFT conv, the OTF and the linear conv."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppvision_tpu.optics import fourier as jf
from ppvision_tpu_torch.ops.fftconv import fftconv_circular, fftconv_circular_ref
from ppvision_tpu_torch.optics import fourier as tf


def _data(seed, b, h, w, c):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, h, w, c)).astype(np.float32),
        rng.standard_normal((h, w, c)).astype(np.float32),
    )


# rtol/atol 2e-5: the JAX package's own fused-vs-unfused bound
# (tests/test_fftconv.py); both sides are f32 FFTs of O(1) data.
@pytest.mark.parametrize("b,h,w,c", [(4, 16, 16, 3), (2, 32, 16, 8), (3, 8, 24, 4)])
def test_fftconv_matches_jax_circular_conv(b, h, w, c):
    img, ker = _data(0, b, h, w, c)
    want = np.asarray(jf.fft_conv2d_circular(jnp.asarray(img), jnp.asarray(ker)))
    otf = torch.fft.fft2(torch.from_numpy(ker), dim=(0, 1))
    got = fftconv_circular(torch.from_numpy(img), otf.real, otf.imag).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    via_fourier = tf.fft_conv2d_circular(torch.from_numpy(img), torch.from_numpy(ker)).numpy()
    np.testing.assert_allclose(via_fourier, want, rtol=2e-5, atol=2e-5)


def test_fftconv_matches_jax_circular_conv_at_the_video_path_size():
    # The camera's n = 256 at B = 2: sums of 65,536 terms, so the bound is
    # scaled to the output.
    img, ker = _data(3, 2, 256, 256, 3)
    want = np.asarray(jf.fft_conv2d_circular(jnp.asarray(img), jnp.asarray(ker)))
    otf = torch.fft.fft2(torch.from_numpy(ker), dim=(0, 1))
    got = fftconv_circular(torch.from_numpy(img), otf.real, otf.imag).numpy()
    assert np.abs(got - want).max() <= 2e-5 * max(1.0, np.abs(want).max())


def test_fftconv_cpu_tensors_take_the_plain_version():
    img, ker = _data(1, 2, 8, 8, 3)
    otf = torch.fft.fft2(torch.from_numpy(ker), dim=(0, 1))
    before = fftconv_circular.launches
    got = fftconv_circular(torch.from_numpy(img), otf.real, otf.imag)
    assert fftconv_circular.launches == before  # no kernel on the CPU
    want = fftconv_circular_ref(torch.from_numpy(img), otf.real, otf.imag)
    assert torch.equal(got, want)


def test_psf2otf_and_linear_conv_match_jax():
    rng = np.random.default_rng(2)
    psf = rng.random((9, 9, 3)).astype(np.float32)
    img = rng.random((2, 16, 16, 3)).astype(np.float32)
    jr, ji = jf.psf2otf_split(jnp.asarray(psf), (20, 20))
    tr, ti = tf.psf2otf_split(torch.from_numpy(psf), (20, 20))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-5)
    want = np.asarray(jf.fft_conv2d_linear(jnp.asarray(img), jnp.asarray(psf)))
    got = tf.fft_conv2d_linear(torch.from_numpy(img), torch.from_numpy(psf)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

