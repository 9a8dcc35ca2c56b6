"""The port's face data pipeline (data/face.py, data/native.py) against
the JAX package's ``ppvision_tpu.data.face`` on a folder of PIL-written
PNG and JPEG faces: the same seed gives bit-identical batches on the PIL
path, the native path and the fully native JPEG path, and
``eval_batches`` gives identical arrays."""

import numpy as np
import pytest

from ppvision_tpu.data import face as jface
from ppvision_tpu_torch.data import face as tface
from ppvision_tpu_torch.data import native

IMG = 32
SIZES = ((40, 36), (48, 48), (36, 52))


def _write(root, ext: str, seed: int, n: int = 3) -> None:
    from PIL import Image

    rng = np.random.default_rng(seed)
    for cls in ("female", "male"):
        d = root / cls
        d.mkdir(parents=True)
        for i in range(n):
            h, w = SIZES[i % len(SIZES)]
            # Smooth faces-like images (JPEG keeps them close to the array).
            base = rng.integers(0, 256, (h // 4 + 1, w // 4 + 1, 3), dtype=np.uint8)
            img = Image.fromarray(base).resize((w, h), Image.BILINEAR)
            e = ext if ext != "mixed" else ("png", "jpg")[i % 2]
            img.save(d / f"{i:03d}.{e}")


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("faces")
    out = {}
    for ext, seed in (("mixed", 0), ("jpg", 1)):
        out[ext] = (root / f"{ext}_src", root / f"{ext}_ref")
        _write(out[ext][0], ext, seed)
        _write(out[ext][1], ext, seed + 10)
    return out


def _batches(module, src, ref, use_native: bool, n: int = 2, **kw):
    b = module.FaceBatcher(str(src), str(ref), img_size=IMG, batch_size=4, latent_dim=8, seed=3,
                           use_native=use_native, process_index=0, process_count=1, **kw)
    try:
        return [next(b) for _ in range(n)]
    finally:
        b.close()


@pytest.mark.parametrize("case", ["pil", "native", "native_jpeg"])
def test_face_batcher_matches_jax(folders, case):
    """``FaceBatcher`` draws the JAX package's random stream: the same
    seed gives the same batches, bit for bit, on every decode path."""
    use_native = case != "pil"
    if use_native and not native.available():
        pytest.fail("the native transform library did not build (g++ is here)")
    if case == "native_jpeg":
        assert native.has_jpeg(), "libjpeg is here: the fully native JPEG path must build"
    src, ref = folders["jpg" if case == "native_jpeg" else "mixed"]
    got = _batches(tface, src, ref, use_native, crop_prob=0.5)
    want = _batches(jface, src, ref, use_native, crop_prob=0.5)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"x_src", "y_src", "x_ref", "x_ref2", "y_ref", "z_trg", "z_trg2"}
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert got[0]["x_src"].shape == (4, IMG, IMG, 3) and got[0]["x_src"].dtype == np.float32


def test_native_entry_points_match_jax(folders):
    """``transform_one``, ``decode_jpeg`` and ``jpeg_dims`` of the port's
    loader equal the JAX package's on the same bytes and geometry."""
    from ppvision_tpu.data import native as jnative

    path = sorted((folders["jpg"][0] / "male").iterdir())[1]
    data = path.read_bytes()
    assert native.jpeg_dims(data) == jnative.jpeg_dims(data) == (48, 48)
    img = native.decode_jpeg(data)
    np.testing.assert_array_equal(img, jnative.decode_jpeg(data))
    np.testing.assert_array_equal(native.transform_one(img, (2, 3, 40, 36), (IMG, IMG), flip=True),
                                  jnative.transform_one(img, (2, 3, 40, 36), (IMG, IMG), flip=True))


@pytest.mark.parametrize("kw", [dict(), dict(imagenet_normalize=True), dict(shuffle=True, seed=5)])
def test_eval_batches_match_jax(folders, kw):
    src = str(folders["mixed"][0])
    got = list(tface.eval_batches(src, IMG, batch_size=4, **kw))
    want = list(jface.eval_batches(src, IMG, batch_size=4, **kw))
    shape = want[0].shape[1:]
    assert [g.shape for g in got] == [w.shape for w in want] == [(4, *shape), (2, *shape)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_datasets_and_sampling_match_jax(folders):
    src, ref = (str(p) for p in folders["mixed"])
    a, b = tface.ImageFolderDataset(src), jface.ImageFolderDataset(src)
    assert a.samples == b.samples and a.targets == b.targets and a.classes == b.classes == ["female", "male"]
    a, b = tface.ReferenceDataset(ref, seed=4), jface.ReferenceDataset(ref, seed=4)
    assert a.samples2 == b.samples2
    ra, rb = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(3):
        assert tface._sample_crop_box((48, 40), ra) == jface._sample_crop_box((48, 40), rb)
    np.testing.assert_array_equal(tface._balanced_indices([0, 0, 1], np.random.default_rng(2), 16),
                                  jface._balanced_indices([0, 0, 1], np.random.default_rng(2), 16))
