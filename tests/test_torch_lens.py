"""The port's captioning lens (optics/lens.py) against the JAX package's.

At ``LensSpec(wave_res=64, patch_size=32, zernike_terms=16,
height_tolerance=0)``: the folded constants (with and without frozen
coefficients), ``lens_psf``, ``lens_apply``
in all four mask modes, the general nearest-resize downsample branch
(``wave_res=100, patch_size=64``) and ``d(loss)/d(defocus)``, each within
1e-9 of the max at f64 and 1e-4 of the max at f32.  Also: the exact-disk
mask where cv2 does not import, ``resize_nearest`` against
``F.interpolate``, and the height noise drawn from one generator.
"""

import builtins
import contextlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppvision_tpu.optics import lens as jl
from ppvision_tpu_torch.ops.image import resize_nearest
from ppvision_tpu_torch.optics import lens as tl

from .torch_parity import two_threads  # noqa: F401

SPEC = dict(wave_res=64, patch_size=32, zernike_terms=16, height_tolerance=0.0)
TOL = {"float64": 1e-9, "float32": 1e-4}


@contextlib.contextmanager
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _close(got, want, dtype: str, what: str):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= TOL[dtype] * max(np.abs(want).max(), 1e-30), (what, err)


def _images(b: int, p: int, dtype) -> np.ndarray:
    return np.random.default_rng(3).random((b, p, p, 3)).astype(dtype)


def _both(spec_kw: dict, dtype: str, defocus: float = -22.0):
    """(jax params, jax consts, jax spec, port lens, port consts, port spec)."""
    js, ts = jl.LensSpec(**spec_kw), tl.LensSpec(**spec_kw)
    npdt = np.dtype(dtype)
    jp = jl.init_lens_params(js)
    jp = jl.LensParams(*(jnp.asarray(np.asarray(a), npdt) for a in jp))
    jp = jp._replace(defocus=jnp.asarray(defocus, npdt))
    jc = jl.make_lens_constants(js, dtype=npdt)
    tdt = getattr(torch, dtype)
    lens = tl.init_lens_params(ts).to(tdt)
    with torch.no_grad():
        lens.zernike_coeffs_train.fill_(defocus)
    tc = tl.make_lens_constants(ts, dtype=tdt)
    return jp, jc, js, lens, tc, ts


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_constants_and_psf_match_jax(dtype):
    ctx = _x64() if dtype == "float64" else contextlib.nullcontext()
    with ctx:
        jp, jc, js, lens, tc, ts = _both(SPEC, dtype)
        _close(tc.height_base, jc.height_base, dtype, "height_base")
        _close(tc.defocus_plane, jc.defocus_plane, dtype, "defocus_plane")
        _close(tc.phase_scale.reshape(-1), jc.phase_scale, dtype, "phase_scale")
        _close(tc.static_pre.real.permute(1, 2, 0), jc.static_pre[0], dtype, "static_pre re")
        _close(tc.static_pre.imag.permute(1, 2, 0), jc.static_pre[1], dtype, "static_pre im")
        _close(tc.fresnel_h.real.permute(1, 2, 0), jc.fresnel_h[0], dtype, "fresnel re")
        _close(tc.fresnel_h.imag.permute(1, 2, 0), jc.fresnel_h[1], dtype, "fresnel im")
        np.testing.assert_array_equal(tc.mask_keep.numpy(), np.asarray(jc.mask_keep))
        want, wcoef = jl.lens_psf(jp, jc, js)
        got, gcoef = tl.lens_psf(lens, tc, ts)
        assert got.dtype == getattr(torch, dtype)
        _close(got.detach(), want, dtype, "psf")
        np.testing.assert_array_equal(gcoef.detach().numpy(), np.asarray(wcoef))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_frozen_coefficients_fold_as_in_jax(dtype):
    """A warm start's nonzero frozen coefficients fold into the height base
    (the defocus entry ignored), as the JAX package folds them."""
    frozen = np.random.default_rng(5).standard_normal(16) * 0.1
    ctx = _x64() if dtype == "float64" else contextlib.nullcontext()
    with ctx:
        jc = jl.make_lens_constants(jl.LensSpec(**SPEC), frozen_coeffs=frozen, dtype=np.dtype(dtype))
        tc = tl.make_lens_constants(tl.LensSpec(**SPEC), frozen_coeffs=frozen, dtype=getattr(torch, dtype))
        _close(tc.height_base, jc.height_base, dtype, "height_base")
        _close(tc.defocus_plane, jc.defocus_plane, dtype, "defocus_plane")
        assert float(np.abs(tc.height_base.numpy()).max()) > 0


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["1", "2", "3", None])
def test_lens_apply_matches_jax_in_every_mask_mode(dtype, mode):
    ctx = _x64() if dtype == "float64" else contextlib.nullcontext()
    with ctx:
        jp, jc, js, lens, tc, ts = _both(SPEC, dtype)
        img = _images(2, 32, np.dtype(dtype))
        want = jl.lens_apply(jp, jc, js, jnp.asarray(img), mask_mode=mode)
        got = tl.lens_apply(lens, tc, ts, torch.from_numpy(img), mask_mode=mode)
        _close(got.sensor.detach(), want.sensor, dtype, "sensor")
        _close(got.psf.detach(), want.psf, dtype, "psf")
        np.testing.assert_allclose(float(got.psf_loss.detach()), float(want.psf_loss),
                                   rtol=TOL[dtype], atol=TOL[dtype] * 1e-6)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_resize_nearest_branch_matches_jax(dtype):
    """100 -> 64 needs an lcm upsample of 25x, over the reference's 10x
    cap: its nearest resize to 640^2, then a 10x10 mean pool."""
    kw = dict(SPEC, wave_res=100, patch_size=64)
    assert tl._downsample_plan(100, 64) == jl._downsample_plan(100, 64) == (10, 1)
    ctx = _x64() if dtype == "float64" else contextlib.nullcontext()
    with ctx:
        jp, jc, js, lens, tc, ts = _both(kw, dtype)
        want, _ = jl.lens_psf(jp, jc, js)
        got, _ = tl.lens_psf(lens, tc, ts)
        _close(got.detach(), want, dtype, "psf")


@pytest.mark.parametrize("n,p", [(64, 32), (96, 64), (100, 64), (72, 64), (896, 256)])
def test_downsample_plan_is_the_jax_packages(n, p):
    assert tl._downsample_plan(n, p) == jl._downsample_plan(n, p)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_defocus_gradient_matches_jax(dtype):
    """d(sum(sensor * w) + 30 psf_loss)/d(defocus), from a defocus off the
    init so the gradient is not small."""
    ctx = _x64() if dtype == "float64" else contextlib.nullcontext()
    with ctx:
        jp, jc, js, lens, tc, ts = _both(SPEC, dtype, defocus=-3.0)
        img = _images(2, 32, np.dtype(dtype))
        w = np.random.default_rng(4).random(img.shape).astype(np.dtype(dtype))

        def jloss(d):
            res = jl.lens_apply(jp._replace(defocus=d), jc, js, jnp.asarray(img), mask_mode="3")
            return jnp.sum(res.sensor * w) + 30.0 * res.psf_loss

        want = jax.grad(jloss)(jp.defocus)
        res = tl.lens_apply(lens, tc, ts, torch.from_numpy(img), mask_mode="3")
        loss = torch.sum(res.sensor * torch.from_numpy(w)) + 30.0 * res.psf_loss
        (got,) = torch.autograd.grad(loss, [lens.zernike_coeffs_train])
        assert lens.zernike_coeffs_no_train.grad is None and lens.zernike_coeffs_no_train2.grad is None
        np.testing.assert_allclose(float(got), float(want), rtol=10 * TOL[dtype])


def test_exact_disk_mask_where_cv2_does_not_import(monkeypatch):
    """Without cv2 both packages fall back to the exact disk r <= 32."""
    real_import = builtins.__import__

    def no_cv2(name, *a, **kw):
        if name == "cv2":
            raise ImportError("cv2 hidden")
        return real_import(name, *a, **kw)

    monkeypatch.delitem(sys.modules, "cv2", raising=False)
    monkeypatch.setattr(builtins, "__import__", no_cv2)
    spec = dict(SPEC, wave_res=64, patch_size=96)
    jc = jl.make_lens_constants(jl.LensSpec(**spec))
    tc = tl.make_lens_constants(tl.LensSpec(**spec))
    keep = tc.mask_keep.numpy()
    np.testing.assert_array_equal(keep, np.asarray(jc.mask_keep))
    yy, xx = np.indices((96, 96))
    np.testing.assert_array_equal(keep[..., 0], (np.hypot(yy - 48, xx - 48) <= 32).astype(np.float32))


def test_resize_nearest_is_torch_interpolate_nearest():
    x = torch.from_numpy(np.random.default_rng(0).random((3, 9, 7)))
    for hw in ((20, 13), (4, 3), (9, 7)):
        want = torch.nn.functional.interpolate(x[None], size=hw, mode="nearest")[0]
        assert torch.equal(resize_nearest(x, hw), want)


def test_height_noise_comes_from_the_generator():
    """Noise on: the same seed gives the same PSF, another seed another;
    without a generator there is no noise."""
    spec = tl.LensSpec(**dict(SPEC, height_tolerance=2e-8))
    lens, tc = tl.init_lens_params(spec), tl.make_lens_constants(spec)
    clean, _ = tl.lens_psf(lens, tc, spec)
    a, _ = tl.lens_psf(lens, tc, spec, torch.Generator().manual_seed(1))
    b, _ = tl.lens_psf(lens, tc, spec, torch.Generator().manual_seed(1))
    c, _ = tl.lens_psf(lens, tc, spec, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, clean)
