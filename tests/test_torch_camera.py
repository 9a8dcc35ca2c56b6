"""Port camera (optics/zernike.py, optics/camera.py) against the JAX
package: the Zernike basis, the PSF, its two regularizers and the
sensor image, with the reference's coupled-wavelength DFT on and off."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppvision_tpu.optics import camera as jc
from ppvision_tpu.optics.zernike import zernike_basis as jax_zernike_basis
from ppvision_tpu_torch.optics import camera as tc
from ppvision_tpu_torch.optics.zernike import zernike_basis, zernike_volume
from ppvision_tpu_torch.utils.jax_params import camera_state_dict


def test_zernike_basis_is_the_jax_basis():
    np.testing.assert_array_equal(zernike_basis(36, 24), jax_zernike_basis(36, 24))
    vol = zernike_volume(24, 36, use_disk_cache=False)
    assert vol.dtype == np.float32 and vol.shape == (36, 24, 24)


@pytest.mark.parametrize("n,couple", [(32, True), (64, True), (64, False)])
def test_psf_and_sensor_image_match_jax(n, couple):
    jspec = jc.CameraSpec(n=n, zernike_terms=16, couple_wavelengths=couple)
    tspec = tc.CameraSpec(n=n, zernike_terms=16, couple_wavelengths=couple)
    params = jc.init_camera_params(jax.random.key(n), jspec)
    img = np.random.default_rng(n).random((3, n, n, 3)).astype(np.float32)
    j_sensor, j_res = jc.camera_apply(params, jc.make_camera_constants(jspec), jnp.asarray(img))

    cam = tc.Camera(tspec)
    cam.load_state_dict(camera_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        t_sensor, t_res = tc.camera_apply(cam, tc.make_camera_constants(tspec), torch.from_numpy(img))

    # The PSF is two f32 FFT passes of unit-modulus fields times the f64-
    # folded chirps, normalized to sum 1: errors are f32 FFT rounding
    # relative to the PSF's peak.
    j_psf = np.asarray(j_res.psf)
    peak = np.abs(j_psf).max()
    np.testing.assert_allclose(t_res.psf.numpy(), j_psf, rtol=0, atol=1e-4 * peak)
    np.testing.assert_allclose(float(t_res.loss_rad), float(j_res.loss_rad), rtol=1e-4)
    np.testing.assert_allclose(
        float(t_res.centering_loss), float(j_res.centering_loss), rtol=1e-4, atol=1e-12
    )
    # The sensor image is max-normalized to 1: absolute f32 bound.
    np.testing.assert_allclose(t_sensor.numpy(), np.asarray(j_sensor), rtol=0, atol=2e-5)


def test_camera_state_dict_uses_reference_names_and_shapes():
    spec = tc.CameraSpec(n=32, zernike_terms=16)
    sd = tc.Camera(spec, seed=3).state_dict()
    assert set(sd) == {"Zer_train", "Zer_no_train"}
    assert sd["Zer_train"].shape == (13, 1, 1) and sd["Zer_no_train"].shape == (3, 1, 1)
    assert float(sd["Zer_no_train"].abs().max()) == 0.0
    assert 0.0 <= float(sd["Zer_train"].min()) and float(sd["Zer_train"].max()) < 0.01


def test_camera_constants_are_folded_on_the_host_in_f64():
    spec = dataclasses.replace(tc.CameraSpec(), n=32, zernike_terms=8)
    consts = tc.make_camera_constants(spec)
    jconsts = jc.make_camera_constants(jc.CameraSpec(n=32, zernike_terms=8))
    assert consts.chirp_pre.dtype == torch.complex64
    np.testing.assert_array_equal(consts.chirp_pre.real.numpy(), np.asarray(jconsts.chirp_pre[0]))
    np.testing.assert_array_equal(consts.chirp_post.imag.numpy(), np.asarray(jconsts.chirp_post[1]))
    np.testing.assert_array_equal(consts.phase_scale.numpy(), np.asarray(jconsts.phase_scale))
