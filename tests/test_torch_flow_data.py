"""The port's flow data module (data/flow.py) against the JAX package's:
files written by one read by the other (.flo, KITTI png, PFM), the color
wheel image, ``FlowAugmentor`` bit for bit for a seed (the eraser
included), and the named datasets indexing the same files of a temp
tree, the sparse branch's skip of the augmentor included."""

import numpy as np
import pytest
from PIL import Image

from ppvision_tpu.data import flow as jflow
from ppvision_tpu_torch.data import flow as tflow


def _flow(seed: int, hw=(20, 24)) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((*hw, 2)) * 8).astype(np.float32)


@pytest.mark.parametrize("writer,reader", [(jflow, tflow), (tflow, jflow)])
def test_files_cross_between_the_packages(tmp_path, writer, reader):
    f = _flow(0)
    writer.write_flo(str(tmp_path / "a.flo"), f)
    np.testing.assert_array_equal(reader.read_flo(str(tmp_path / "a.flo")), f)
    valid = np.random.default_rng(1).random(f.shape[:2]) < 0.7
    writer.write_flow_kitti(str(tmp_path / "a.png"), f, valid)
    got, got_valid = reader.read_flow_kitti(str(tmp_path / "a.png"))
    want, want_valid = writer.read_flow_kitti(str(tmp_path / "a.png"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_valid, valid)
    assert np.abs(got - f).max() <= 1 / 64
    for image in (f[..., 0], np.concatenate([f, f[..., :1]], -1)):
        writer.write_pfm(str(tmp_path / "a.pfm"), image)
        np.testing.assert_array_equal(reader.read_pfm(str(tmp_path / "a.pfm")), image)
    for ext in ("flo", "pfm", "png"):
        got, want = reader.read_flow_any(str(tmp_path / f"a.{ext}")), writer.read_flow_any(str(tmp_path / f"a.{ext}"))
        np.testing.assert_array_equal(got[0], want[0])


def test_flow_to_image_equal():
    f = _flow(2, (33, 40))
    for clip in (None, 5.0):
        np.testing.assert_array_equal(tflow.flow_to_image(f, clip), jflow.flow_to_image(f, clip))


def test_augmentor_bit_for_bit():
    rng = np.random.default_rng(3)
    img1 = rng.uniform(0, 255, (120, 140, 3)).astype(np.float32)
    img2 = rng.uniform(0, 255, (120, 140, 3)).astype(np.float32)
    f = _flow(4, (120, 140))
    for seed in range(6):
        ta = tflow.FlowAugmentor((64, 80), seed=seed)
        ja = jflow.FlowAugmentor((64, 80), seed=seed)
        for _ in range(2):
            got, want = ta(img1, img2, f), ja(img1, img2, f)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)
        assert ta.rng.bit_generator.state == ja.rng.bit_generator.state
    # The eraser alone: it paints over img2 at some seeds and not at others.
    fired = []
    for seed in range(6):
        _, t2 = tflow.FlowAugmentor((64, 80), seed=seed)._eraser(img1, img2)
        _, j2 = jflow.FlowAugmentor((64, 80), seed=seed)._eraser(img1, img2)
        np.testing.assert_array_equal(t2, j2)
        fired.append(not np.array_equal(t2, img2))
    assert any(fired) and not all(fired)


def _png(path, seed: int, hw=(24, 32)):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(np.random.default_rng(seed).integers(0, 256, (*hw, 3), dtype=np.uint8)).save(path)


def test_named_datasets_index_the_same_files(tmp_path):
    # Sintel: two scenes of three frames and their .flo files.
    root = tmp_path / "Sintel"
    for s, scene in enumerate(("alley", "bamboo")):
        for i in range(3):
            _png(root / "training" / "clean" / scene / f"frame_{i:04d}.png", 10 * s + i)
        for i in range(2):
            (root / "training" / "flow" / scene).mkdir(parents=True, exist_ok=True)
            jflow.write_flo(str(root / "training" / "flow" / scene / f"frame_{i:04d}.flo"), _flow(s + i, (24, 32)))
    # KITTI: two pairs and their sparse flows.
    kroot = tmp_path / "KITTI"
    for i in range(2):
        _png(kroot / "training" / "image_2" / f"{i:06d}_10.png", 40 + i)
        _png(kroot / "training" / "image_2" / f"{i:06d}_11.png", 50 + i)
        (kroot / "training" / "flow_occ").mkdir(parents=True, exist_ok=True)
        jflow.write_flow_kitti(str(kroot / "training" / "flow_occ" / f"{i:06d}_10.png"), _flow(60 + i, (24, 32)),
                               np.ones((24, 32), bool))
    # Chairs: three image pairs and their flows in one folder.
    croot = tmp_path / "chairs"
    for i in range(3):
        _png(croot / f"{i:05d}_img1.ppm", 70 + i)
        _png(croot / f"{i:05d}_img2.ppm", 80 + i)
        jflow.write_flo(str(croot / f"{i:05d}_flow.flo"), _flow(90 + i, (24, 32)))
    pairs = [
        (tflow.MpiSintel(root=str(root)), jflow.MpiSintel(root=str(root))),
        (tflow.KITTI(root=str(kroot)), jflow.KITTI(root=str(kroot))),
        (tflow.FlyingChairs(root=str(croot)), jflow.FlyingChairs(root=str(croot))),
        (tflow.FlyingThings3D(root=str(tmp_path / "none")), jflow.FlyingThings3D(root=str(tmp_path / "none"))),
        (tflow.HD1K(root=str(tmp_path / "none")), jflow.HD1K(root=str(tmp_path / "none"))),
    ]
    for t, j in pairs:
        assert (t.image_list, t.flow_list, t.extra_info) == (j.image_list, j.flow_list, j.extra_info)
    assert [len(t) for t, _ in pairs] == [4, 2, 3, 0, 0]
    combined = pairs[0][0] * 2 + pairs[1][0]
    assert len(combined) == 10
    # Samples equal, the augmentor run on the dense Sintel pair and
    # skipped on the sparse KITTI one.
    for name, path in (("MpiSintel", root), ("KITTI", kroot)):
        t = getattr(tflow, name)(tflow.FlowAugmentor((16, 16), seed=5), root=str(path))
        j = getattr(jflow, name)(jflow.FlowAugmentor((16, 16), seed=5), root=str(path))
        for a, b in zip(t[0], j[0]):
            np.testing.assert_array_equal(a, b)
        assert (t[0][0].shape[:2] == (16, 16)) == (name == "MpiSintel")
