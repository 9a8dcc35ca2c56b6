"""Optical-flow data utilities (RAFT auxiliary stack).

The port's copy of ``ppvision_tpu/data/flow.py``, host-side numpy with
OpenCV and PIL imported inside the functions that need them; no device
code reaches it.  It covers the reference's flow-side components
(``Face-DeId/RAFT/core/{datasets.py, utils/augmentor.py,
utils/flow_viz.py, utils/frame_utils.py}``): .flo / KITTI-png / PFM
flow IO, the Middlebury color wheel visualization, Sintel/Chairs-style
dataset indexing, and a photometric+spatial augmentor that draws the
JAX package's ``default_rng`` stream for a seed.  Like the JAX module,
a sparse (KITTI, HD1K) sample skips the augmentor.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path

import numpy as np

__all__ = [
    "read_flo",
    "write_flo",
    "read_flow_kitti",
    "write_flow_kitti",
    "read_pfm",
    "write_pfm",
    "read_flow_any",
    "flow_to_image",
    "FlowPairDataset",
    "FlowAugmentor",
    "FlowDataset",
    "MpiSintel",
    "FlyingChairs",
    "FlyingThings3D",
    "KITTI",
    "HD1K",
]

_FLO_MAGIC = 202021.25


def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo -> (H, W, 2) float32."""
    with open(path, "rb") as f:
        magic = struct.unpack("f", f.read(4))[0]
        if abs(magic - _FLO_MAGIC) > 1e-3:
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = struct.unpack("i", f.read(4))[0]
        h = struct.unpack("i", f.read(4))[0]
        data = np.frombuffer(f.read(h * w * 2 * 4), np.float32)
    return data.reshape(h, w, 2).copy()


def write_flo(path: str, flow: np.ndarray) -> None:
    h, w, _ = flow.shape
    with open(path, "wb") as f:
        f.write(struct.pack("f", _FLO_MAGIC))
        f.write(struct.pack("i", w))
        f.write(struct.pack("i", h))
        f.write(flow.astype(np.float32).tobytes())


def read_flow_kitti(path: str) -> tuple[np.ndarray, np.ndarray]:
    """KITTI 16-bit png -> ((H, W, 2) flow, (H, W) valid mask)."""
    import cv2

    raw = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR).astype(np.float64)
    flow = raw[:, :, ::-1][:, :, :2]  # BGR -> RGB, first two channels
    valid = raw[:, :, 0] > 0  # BGR: third RGB channel = first BGR
    flow = (flow - 2**15) / 64.0
    return flow.astype(np.float32), valid


def write_flow_kitti(path: str, flow: np.ndarray, valid: np.ndarray | None = None):
    import cv2

    h, w, _ = flow.shape
    out = np.ones((h, w, 3), np.uint16)
    out[:, :, :2] = np.clip(flow * 64.0 + 2**15, 0, 2**16 - 1).astype(np.uint16)
    if valid is not None:
        out[:, :, 2] = valid.astype(np.uint16)
    cv2.imwrite(path, out[:, :, ::-1])


def _color_wheel() -> np.ndarray:
    """Middlebury color wheel (55 colors)."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    cols = np.zeros((ry + yg + gc + cb + bm + mr, 3))
    col = 0
    cols[:ry, 0] = 255
    cols[:ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    cols[col : col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    cols[col : col + yg, 1] = 255
    col += yg
    cols[col : col + gc, 1] = 255
    cols[col : col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    cols[col : col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    cols[col : col + cb, 2] = 255
    col += cb
    cols[col : col + bm, 2] = 255
    cols[col : col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    cols[col : col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    cols[col : col + mr, 0] = 255
    return cols


def flow_to_image(flow: np.ndarray, clip: float | None = None) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 color-wheel visualization."""
    if clip is not None:
        flow = np.clip(flow, -clip, clip)
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u**2 + v**2)
    rad_max = max(rad.max(), 1e-6)
    u, v = u / rad_max, v / rad_max
    rad = rad / rad_max

    wheel = _color_wheel()
    n = wheel.shape[0]
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (n - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % n
    f = fk - k0
    img = np.zeros(flow.shape[:2] + (3,), np.uint8)
    for c in range(3):
        col0 = wheel[k0, c] / 255.0
        col1 = wheel[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        col = 1 - rad * (1 - col)  # saturate with radius
        img[..., c] = np.floor(255 * col)
    return img


class FlowPairDataset:
    """Sintel-style (frame_t, frame_t+1, flow) triples from directories."""

    def __init__(self, image_root: str, flow_root: str | None = None, ext: str = "png"):
        self.pairs: list[tuple[str, str]] = []
        self.flows: list[str | None] = []
        for scene in sorted(Path(image_root).iterdir()):
            if not scene.is_dir():
                continue
            frames = sorted(str(p) for p in scene.glob(f"*.{ext}"))
            for a, b in zip(frames[:-1], frames[1:]):
                self.pairs.append((a, b))
                if flow_root:
                    flo = os.path.join(
                        flow_root, scene.name, Path(a).stem + ".flo"
                    )
                    self.flows.append(flo if os.path.exists(flo) else None)
                else:
                    self.flows.append(None)

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, i: int):
        from PIL import Image

        a, b = self.pairs[i]
        img1 = np.asarray(Image.open(a).convert("RGB"), np.float32)
        img2 = np.asarray(Image.open(b).convert("RGB"), np.float32)
        flow = read_flo(self.flows[i]) if self.flows[i] else None
        return img1, img2, flow


class FlowAugmentor:
    """Photometric + spatial augmentation for flow training pairs
    (asymmetric color jitter, random scale/stretch, flips, crop —
    the reference augmentor's behavior, RAFT/core/utils/augmentor.py)."""

    def __init__(
        self,
        crop_size: tuple[int, int],
        min_scale: float = -0.2,
        max_scale: float = 0.5,
        do_flip: bool = True,
        seed: int = 0,
    ):
        self.crop = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.do_flip = do_flip
        self.rng = np.random.default_rng(seed)

    def _photometric(self, img1, img2):
        rng = self.rng
        # Asymmetric with prob 0.2: jitter each frame independently.
        asym = rng.random() < 0.2
        imgs = [img1, img2] if asym else [np.stack([img1, img2])]
        out = []
        for im in imgs:
            brightness = rng.uniform(0.6, 1.4)
            contrast = rng.uniform(0.6, 1.4)
            im = im * brightness
            mean = im.mean(axis=(-3, -2, -1), keepdims=True)
            im = (im - mean) * contrast + mean
            gamma = rng.uniform(0.7, 1.3)
            im = 255.0 * (np.clip(im, 0, 255) / 255.0) ** gamma
            out.append(im)
        if asym:
            img1, img2 = out
        else:
            img1, img2 = out[0][0], out[0][1]
        return np.clip(img1, 0, 255), np.clip(img2, 0, 255)

    def _spatial(self, img1, img2, flow):
        import cv2

        rng = self.rng
        h, w = img1.shape[:2]
        ch, cw = self.crop
        min_needed = max((ch + 8) / h, (cw + 8) / w)
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        sx = max(scale, min_needed)
        sy = max(scale, min_needed)
        if rng.random() < 0.8:  # stretch
            sx *= 2 ** rng.uniform(-0.2, 0.2)
            sy *= 2 ** rng.uniform(-0.2, 0.2)
        sx, sy = max(sx, min_needed), max(sy, min_needed)
        nw, nh = int(round(w * sx)), int(round(h * sy))
        img1 = cv2.resize(img1, (nw, nh), interpolation=cv2.INTER_LINEAR)
        img2 = cv2.resize(img2, (nw, nh), interpolation=cv2.INTER_LINEAR)
        flow = cv2.resize(flow, (nw, nh), interpolation=cv2.INTER_LINEAR)
        flow = flow * [sx, sy]

        if self.do_flip and rng.random() < 0.5:  # horizontal
            img1 = img1[:, ::-1]
            img2 = img2[:, ::-1]
            flow = flow[:, ::-1] * [-1.0, 1.0]
        if self.do_flip and rng.random() < 0.1:  # vertical
            img1 = img1[::-1]
            img2 = img2[::-1]
            flow = flow[::-1] * [1.0, -1.0]

        y0 = int(rng.integers(0, nh - ch + 1))
        x0 = int(rng.integers(0, nw - cw + 1))
        return (
            img1[y0 : y0 + ch, x0 : x0 + cw],
            img2[y0 : y0 + ch, x0 : x0 + cw],
            flow[y0 : y0 + ch, x0 : x0 + cw],
        )

    def _eraser(self, img1, img2, bounds=(50, 100), p=0.5):
        """Occlusion augmentation (reference augmentor.py:52-66): with
        prob ``p``, paint 1-2 random mean-color rectangles onto img2."""
        rng = self.rng
        h, w = img1.shape[:2]
        if rng.random() < p:
            mean_color = img2.reshape(-1, 3).mean(axis=0)
            for _ in range(int(rng.integers(1, 3))):
                x0 = int(rng.integers(0, w))
                y0 = int(rng.integers(0, h))
                dx = int(rng.integers(bounds[0], bounds[1]))
                dy = int(rng.integers(bounds[0], bounds[1]))
                img2 = img2.copy()
                img2[y0 : y0 + dy, x0 : x0 + dx] = mean_color
        return img1, img2

    def __call__(self, img1, img2, flow):
        img1, img2 = self._photometric(img1, img2)
        img1, img2 = self._eraser(img1, img2)
        img1, img2, flow = self._spatial(img1, img2, flow)
        return (
            np.ascontiguousarray(img1, np.float32),
            np.ascontiguousarray(img2, np.float32),
            np.ascontiguousarray(flow, np.float32),
        )


def read_pfm(path: str) -> np.ndarray:
    """PFM -> (H, W) or (H, W, 3) float32 (FlyingThings3D flow storage,
    reference frame_utils.py readPFM)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.frombuffer(f.read(), endian + "f")
    data = data.reshape((h, w, 3) if color else (h, w))
    return np.flipud(data).astype(np.float32).copy()


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    image = np.flipud(np.asarray(image, np.float32))
    color = image.ndim == 3 and image.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        f.write(image.tobytes())


def read_flow_any(path: str) -> tuple[np.ndarray, np.ndarray | None]:
    """Dispatch on extension: .flo / .pfm / KITTI .png -> (flow, valid)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".flo":
        return read_flo(path), None
    if ext == ".pfm":
        return read_pfm(path)[..., :2], None
    if ext == ".png":
        return read_flow_kitti(path)
    raise ValueError(f"unknown flow format: {path}")


class FlowDataset:
    """Base flow dataset: (img1, img2, flow, valid) samples with optional
    augmentation (reference RAFT/core/datasets.py:18-99 behavior, numpy).

    Subclasses fill ``image_list`` (pairs of paths), ``flow_list`` and
    ``extra_info``.  ``sparse=True`` marks KITTI/HD1K-style 16-bit pngs
    with validity masks; valid is flow-magnitude-gated otherwise.
    """

    def __init__(self, augmentor: "FlowAugmentor | None" = None, sparse: bool = False):
        self.augmentor = augmentor
        self.sparse = sparse
        self.is_test = False
        self.image_list: list[tuple[str, str]] = []
        self.flow_list: list[str] = []
        self.extra_info: list = []

    def __len__(self):
        return len(self.image_list)

    def __mul__(self, v: int) -> "FlowDataset":
        out = FlowDataset(self.augmentor, self.sparse)
        out.is_test = self.is_test
        out.image_list = list(self.image_list) * v
        out.flow_list = list(self.flow_list) * v
        out.extra_info = list(self.extra_info) * v
        return out

    __rmul__ = __mul__

    def __add__(self, other: "FlowDataset") -> "FlowDataset":
        out = FlowDataset(self.augmentor, self.sparse)
        out.image_list = list(self.image_list) + list(other.image_list)
        out.flow_list = list(self.flow_list) + list(other.flow_list)
        out.extra_info = list(self.extra_info) + list(other.extra_info)
        return out

    def _imread(self, path: str) -> np.ndarray:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"), np.float32)

    def __getitem__(self, i: int):
        a, b = self.image_list[i]
        img1, img2 = self._imread(a), self._imread(b)
        if self.is_test or i >= len(self.flow_list):
            return img1, img2, None, None
        flow, valid = read_flow_any(self.flow_list[i])
        if self.augmentor is not None:
            if self.sparse and valid is not None:
                # Augmentor resize would corrupt sparse validity; crop only.
                pass
            else:
                img1, img2, flow = self.augmentor(img1, img2, flow)
                valid = None
        if valid is None:
            valid = (np.abs(flow[..., 0]) < 1000) & (np.abs(flow[..., 1]) < 1000)
        return img1, img2, flow.astype(np.float32), valid.astype(np.float32)


class MpiSintel(FlowDataset):
    """Sintel layout: root/split/{clean,final}/scene/*.png + flow/*.flo
    (reference datasets.py:102-118)."""

    def __init__(self, augmentor=None, split="training", root="datasets/Sintel",
                 dstype="clean"):
        super().__init__(augmentor)
        image_root = os.path.join(root, split, dstype)
        flow_root = os.path.join(root, split, "flow")
        self.is_test = split == "test"
        for scene in sorted(os.listdir(image_root)) if os.path.isdir(image_root) else []:
            frames = sorted(Path(image_root, scene).glob("*.png"))
            for i in range(len(frames) - 1):
                self.image_list.append((str(frames[i]), str(frames[i + 1])))
                self.extra_info.append((scene, i))
            if not self.is_test:
                self.flow_list += sorted(
                    str(p) for p in Path(flow_root, scene).glob("*.flo")
                )


class FlyingChairs(FlowDataset):
    """Chairs layout: root/*.ppm pairs + *.flo, split by chairs_split.txt
    (reference datasets.py:121-134)."""

    def __init__(self, augmentor=None, split="training",
                 root="datasets/FlyingChairs_release/data", split_file=None):
        super().__init__(augmentor)
        images = sorted(Path(root).glob("*.ppm")) if os.path.isdir(root) else []
        flows = sorted(Path(root).glob("*.flo"))
        split_ids = None
        if split_file and os.path.exists(split_file):
            split_ids = np.loadtxt(split_file, dtype=np.int32)
        for i, flo in enumerate(flows):
            xid = split_ids[i] if split_ids is not None else 1
            want = 1 if split == "training" else 2
            if xid == want:
                self.flow_list.append(str(flo))
                self.image_list.append((str(images[2 * i]), str(images[2 * i + 1])))


class FlyingThings3D(FlowDataset):
    """Things layout: frames_*pass/TRAIN/*/*/left pngs + optical_flow
    pfms, into_future/into_past directions (datasets.py:136-158)."""

    def __init__(self, augmentor=None, root="datasets/FlyingThings3D",
                 dstype="frames_cleanpass"):
        super().__init__(augmentor)
        for direction in ("into_future", "into_past"):
            image_dirs = sorted(Path(root, dstype).glob("TRAIN/*/*")) if os.path.isdir(
                os.path.join(root, dstype)
            ) else []
            for idir in image_dirs:
                fdir = Path(
                    str(idir).replace(dstype, "optical_flow"), direction, "left"
                )
                images = sorted((idir / "left").glob("*.png"))
                flows = sorted(fdir.glob("*.pfm"))
                for i in range(len(flows) - 1):
                    if direction == "into_future":
                        self.image_list.append((str(images[i]), str(images[i + 1])))
                        self.flow_list.append(str(flows[i]))
                    else:
                        self.image_list.append((str(images[i + 1]), str(images[i])))
                        self.flow_list.append(str(flows[i + 1]))


class KITTI(FlowDataset):
    """KITTI-2015 layout: image_2/*_10.png + *_11.png pairs, flow_occ
    16-bit pngs, sparse validity (datasets.py:161-177)."""

    def __init__(self, augmentor=None, split="training", root="datasets/KITTI"):
        super().__init__(augmentor, sparse=True)
        self.is_test = split == "testing"
        base = os.path.join(root, split)
        i1 = sorted(Path(base, "image_2").glob("*_10.png")) if os.path.isdir(base) else []
        i2 = sorted(Path(base, "image_2").glob("*_11.png")) if os.path.isdir(base) else []
        for a, b in zip(i1, i2):
            self.extra_info.append(a.name)
            self.image_list.append((str(a), str(b)))
        if split == "training":
            self.flow_list = sorted(str(p) for p in Path(base, "flow_occ").glob("*_10.png"))


class HD1K(FlowDataset):
    """HD1K layout: hd1k_flow_gt/flow_occ + hd1k_input/image_2, sparse
    (datasets.py:180-195)."""

    def __init__(self, augmentor=None, root="datasets/HD1k"):
        super().__init__(augmentor, sparse=True)
        seq = 0
        while True:
            flows = sorted(Path(root, "hd1k_flow_gt", "flow_occ").glob(f"{seq:06d}_*.png"))
            images = sorted(Path(root, "hd1k_input", "image_2").glob(f"{seq:06d}_*.png"))
            if not flows:
                break
            for i in range(len(flows) - 1):
                self.flow_list.append(str(flows[i]))
                self.image_list.append((str(images[i]), str(images[i + 1])))
            seq += 1
