"""The port's face aligner (models/align.py, models/fan.py) against the
JAX package's and against OpenCV, whose host work the port does in torch:

- ``heatmap_landmarks`` and ``estimate_landmarks`` against the JAX ones;
- the mirror-pad's reflect, 2x shrink, Gaussian blur and 2x grow, and the
  LANCZOS4 perspective warp (its 1/32-px coordinate rounding, its tap
  table, windows partly outside the image) against cv2, piece by piece;
- ``FaceAligner.align`` against the JAX aligner on the same FAN weights
  at 256^2, and ``cli/main.py::run_align`` against the JAX ``run_align``
  on a folder of two PNGs.

Tolerances on the 0-255 scale: f32 sums in another order than OpenCV's
(measured <= 1.9e-4 for the warp, 7.7e-5 for the blur)."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppvision_tpu.models import align as ja
from ppvision_tpu.models.fan import FAN as JFAN
from ppvision_tpu.models.fan import estimate_landmarks as j_estimate
from ppvision_tpu_torch.models import align
from ppvision_tpu_torch.models.fan import FAN, estimate_landmarks
from ppvision_tpu_torch.utils.jax_params import fan_state_dict

from .torch_parity import jax_fan_params, numpy_tree

TOL = 1e-3  # on 0-255 values


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this file's nets: the parallel test
    workers share the host's cores, and more threads a worker only spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _one_cv2_thread():
    cv2.setNumThreads(1)


@pytest.fixture(scope="module")
def fans():
    params = jax_fan_params(3)
    fan = FAN()
    fan.load_state_dict(fan_state_dict(numpy_tree(params)))
    return fan.eval(), params


def _faces(seed: int, b: int = 2, size: int = 256) -> np.ndarray:
    """Faces in [-1, 1] with a smooth blob off centre, so each heatmap's
    peak is interior and clear of ties."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] * (256 / size)
    out = []
    for _ in range(b):
        cy, cx = rng.uniform(100, 156, 2)
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 40.0**2))
        out.append(0.6 * blob[..., None] * rng.uniform(0.5, 1, 3) + 0.1 * rng.random((size, size, 3)))
    return (np.stack(out) * 2 - 1).astype(np.float32)


def _img255(seed: int, hw=(256, 256)) -> np.ndarray:
    return (np.random.default_rng(seed).random((*hw, 3)) * 255).astype(np.float32)


def test_landmarks_match_jax(fans):
    fan, params = fans
    x = _faces(0)
    hm = np.random.default_rng(1).random((2, 16, 16, 98)).astype(np.float32)
    hm[0, 0, 5, 3] = 2.0  # a peak on the border: no sub-pixel shift
    np.testing.assert_array_equal(align.heatmap_landmarks(torch.from_numpy(hm)).numpy(),
                                  np.asarray(ja.heatmap_landmarks(jnp.asarray(hm))))
    want = np.asarray(jax.jit(lambda v: ja.get_landmarks(JFAN(), params, v))(jnp.asarray(x)))
    np.testing.assert_array_equal(align.get_landmarks(fan, torch.from_numpy(x)).numpy(), want)
    want = np.asarray(jax.jit(lambda v: j_estimate(JFAN(), params, v))(jnp.asarray(x)))
    got = estimate_landmarks(fan, torch.from_numpy(x)).numpy()
    assert got.shape == (2, 98, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sigma", [1, 2, 3])
def test_blur_matches_cv2(sigma):
    img = _img255(2)
    want = cv2.GaussianBlur(img, (0, 0), sigma)
    got = align.gaussian_blur_cv2(torch.from_numpy(img)[None], sigma)[0].numpy()
    assert np.abs(got - want).max() <= TOL
    n = len(align._cv2_gaussian_kernel(float(sigma)))
    assert n == 2 * round(4 * sigma) + 1
    np.testing.assert_allclose(align._cv2_gaussian_kernel(float(sigma)), cv2.getGaussianKernel(n, sigma, cv2.CV_32F)[:, 0],
                               rtol=1e-6)


def test_pad_mirror_matches_cv2_and_numpy():
    img = _img255(3)
    x = torch.from_numpy(img)[None]
    padded = np.pad(img, ((128, 128), (128, 128), (0, 0)), "reflect")
    small = cv2.resize(padded, (256, 256))
    got_small = align.resize_bilinear(torch.from_numpy(padded).permute(2, 0, 1)[None], (256, 256))
    assert np.abs(got_small[0].permute(1, 2, 0).numpy() - small).max() <= TOL
    grown = cv2.resize(small, (512, 512))
    got_grown = align.resize_bilinear(torch.from_numpy(small).permute(2, 0, 1)[None], (512, 512))
    assert np.abs(got_grown[0].permute(1, 2, 0).numpy() - grown).max() <= TOL
    want, lm = ja._pad_mirror(img, np.zeros((98, 2), np.float32))
    got = align.pad_mirror(x)[0].numpy()
    assert got.shape == want.shape == (512, 512, 3)
    assert np.abs(got - want).max() <= TOL, np.abs(got - want).max()
    assert (lm == 128).all()


def test_lanczos_table_is_cv2s():
    """Warp impulses by a fraction t (x' = x + t): the output around the
    impulse reads the 8 taps cv2 uses at the rounded fraction."""
    tab = align.lanczos4_table()
    imp = np.zeros((8, 32), np.float32)
    imp[4, 16] = 1.0
    for j in range(32):
        t = (j + 0.3) / 32  # rounds to j / 32 (ties aside)
        mat = np.array([[1, 0, t], [0, 1, 0], [0, 0, 1]], np.float64)
        out = cv2.warpPerspective(imp, mat, (32, 8), flags=cv2.INTER_LANCZOS4)
        # dst x reads src x - t = (x - 1) + (1 - t): frac (32 - j) / 32 for j > 0.
        f = (32 - j) % 32
        base = 16 + (1 if j else 0)
        taps = tab[f]
        got = [out[4, base - k + 3] if 0 <= base - k + 3 < 32 else 0.0 for k in range(8)]
        np.testing.assert_allclose(got, taps, atol=1e-7)
        ours = align.warp_lanczos4(torch.from_numpy(imp)[None, ..., None], mat[None], (8, 32))[0, ..., 0].numpy()
        np.testing.assert_allclose(ours, out, atol=1e-6)


@pytest.mark.parametrize("case", ["similarity", "outside", "subpixel", "perspective"])
def test_warp_matches_cv2(case):
    src = _img255(4, (300, 280))
    if case == "similarity":
        a, s, t = 0.2, 1.1, (-20.0, 15.0)
    elif case == "outside":  # most source windows partly or wholly off the image
        a, s, t = -0.3, 0.8, (150.0, -120.0)
    else:
        a, s, t = 0.0, 1.0, (0.3, -0.7)  # not a multiple of 1/32 px
    mat = np.array([[s * np.cos(a), -s * np.sin(a), t[0]], [s * np.sin(a), s * np.cos(a), t[1]], [0, 0, 1]])
    if case == "perspective":
        mat = mat @ np.array([[1, 0.01, 0], [0.02, 1, 0], [2e-4, -1e-4, 1]])
    want = cv2.warpPerspective(src, mat, (256, 256), flags=cv2.INTER_LANCZOS4)
    got = align.warp_lanczos4(torch.from_numpy(src)[None], mat[None], (256, 256))[0].numpy()
    assert np.abs(got - want).max() <= TOL, np.abs(got - want).max()
    if case == "outside":
        assert 0.05 < (want == 0).mean() < 0.95
    if case == "subpixel":
        # Unrounded Lanczos taps would sit far off cv2's.
        x = np.float32(0.7)  # src x = dst x - 0.3
        exact = align._lanczos4_coeffs(x)
        rounded = align.lanczos4_table()[round(0.7 * 32)]
        assert np.abs(exact - rounded).max() > 1e-3


def test_aligner_matches_jax(fans):
    fan, params = fans
    x = _faces(5)
    mean_lm = np.tile([[128.0, 128.0]], (98, 1)) + np.random.default_rng(6).normal(0, 30, (98, 2))
    want = ja.FaceAligner(JFAN(), params, mean_lm, 256).align(x)
    got = align.FaceAligner(fan, mean_lm, 256).align(x)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() * 127.5 <= TOL


def test_run_align_matches_the_jax_cli(fans, tmp_path, monkeypatch):
    """Both CLIs' ``run_align`` on two PNGs, the wing FAN from one file
    written from the port's module and the mean landmarks from one npz:
    the output PNGs within one level."""
    import dataclasses
    import functools

    import flax.linen as nn
    from PIL import Image

    from ppvision_tpu.cli.main import run_align as jax_run_align
    from ppvision_tpu.config import FaceDeIdConfig as JCfg
    from ppvision_tpu_torch.cli.main import run_align
    from ppvision_tpu_torch.config import FaceDeIdConfig

    fan, _ = fans
    inp = tmp_path / "in"
    inp.mkdir()
    for i, face in enumerate(_faces(7, size=200)):
        Image.fromarray(((face * 0.5 + 0.5) * 255).astype(np.uint8)).save(inp / f"{i}.png")
    wing, lm = str(tmp_path / "wing.ckpt"), str(tmp_path / "lm.npz")
    torch.save(fan.state_dict(), wing)
    np.savez(lm, mean=np.tile([[128.0, 128.0]], (98, 1)) + np.random.default_rng(8).normal(0, 30, (98, 2)))
    cfg = FaceDeIdConfig()
    cfg = dataclasses.replace(cfg, paths=dataclasses.replace(cfg.paths, wing_path=wing, lm_path=lm))
    run_align(cfg, str(inp), str(tmp_path / "port"), device="cpu")
    # The JAX CLI's eager FAN init is replaced by the file, so it is
    # traced for its shapes only.
    init = nn.Module.init

    def shaped_init(self, *a, **kw):
        shapes = jax.eval_shape(functools.partial(init, self, **kw), *a)
        return jax.tree_util.tree_map(lambda t: jnp.zeros(t.shape, t.dtype), shapes)

    monkeypatch.setattr(nn.Module, "init", shaped_init)
    jcfg = JCfg()
    jax_run_align(dataclasses.replace(jcfg, paths=dataclasses.replace(jcfg.paths, wing_path=wing, lm_path=lm)),
                  str(inp), str(tmp_path / "jax"))
    for name in ("0.png", "1.png"):
        got = np.asarray(Image.open(tmp_path / "port" / name), np.int16)
        want = np.asarray(Image.open(tmp_path / "jax" / name), np.int16)
        assert got.shape == want.shape == (256, 256, 3)
        assert np.abs(got - want).max() <= 1
