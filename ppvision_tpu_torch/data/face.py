"""Face-DeId data pipeline (CelebA-HQ style folders).

Port of ``ppvision_tpu/data/face.py`` (the reference's
``Face-DeId/core/data_loader.py``): a host-side numpy/PIL pipeline with
a background-thread prefetcher, drawing the same random stream as the
JAX package for a given seed, so the batches are the same:

- ``ImageFolderDataset``: class-per-subdir labels (torchvision
  ImageFolder semantics, data_loader.py:126-127).
- ``ReferenceDataset``: per-domain (image, second image, label) triples
  (data_loader.py:52-84).
- Balanced domain sampling (WeightedRandomSampler equivalent,
  data_loader.py:101-105) as per-draw inverse-frequency choice.
- Train transform: random-resized-crop (scale 0.8-1, ratio 0.9-1.1)
  with probability 0.5, resize, random hflip, scale to [0, 1], no mean
  normalization (data_loader.py:113-124); on the native C++ library
  (``data/native.py``) where it builds, PIL otherwise.
- ``FaceBatcher``: the InputFetcher equivalent (data_loader.py:195-238),
  an infinite iterator of NHWC float32 numpy batches with fresh gaussian
  latents, one process (data parallelism is not ported).

Images are decoded by ``_load_rgb`` (PIL), and resized by PIL where
their size is not the one asked for.
"""

from __future__ import annotations

import math
import queue
import threading
from pathlib import Path
from typing import Iterator

import numpy as np

__all__ = [
    "list_images",
    "ImageFolderDataset",
    "ReferenceDataset",
    "FaceBatcher",
    "eval_batches",
]

IMG_EXTS = ("png", "jpg", "jpeg", "JPG")
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def list_images(root: str) -> list[str]:
    out: list[str] = []
    for ext in IMG_EXTS:
        out.extend(str(p) for p in Path(root).rglob(f"*.{ext}"))
    return out


def _load_rgb(path: str) -> "np.ndarray":
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _resize(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    from PIL import Image

    if img.shape[:2] == size:
        return img
    return np.asarray(
        Image.fromarray(img).resize((size[1], size[0]), Image.BILINEAR)
    )


def _sample_crop_box(
    hw: tuple[int, int], rng: np.random.Generator, scale=(0.8, 1.0), ratio=(0.9, 1.1)
) -> tuple[int, int, int, int]:
    """torchvision RandomResizedCrop box (y, x, h, w) for an (H, W)
    image; center fallback (10-attempt semantics)."""
    h, w = hw
    area = h * w
    for _ in range(10):
        target = area * rng.uniform(*scale)
        ar = math.exp(rng.uniform(math.log(ratio[0]), math.log(ratio[1])))
        cw = int(round(math.sqrt(target * ar)))
        ch = int(round(math.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return (top, left, ch, cw)
    s = min(h, w)
    return ((h - s) // 2, (w - s) // 2, s, s)


def _random_resized_crop(
    img: np.ndarray, rng: np.random.Generator, out: int,
    scale=(0.8, 1.0), ratio=(0.9, 1.1),
) -> np.ndarray:
    """torchvision RandomResizedCrop semantics (10 attempts + fallback)."""
    top, left, ch, cw = _sample_crop_box(img.shape[:2], rng, scale, ratio)
    return _resize(img[top : top + ch, left : left + cw], (out, out))


def train_transform(
    img: np.ndarray, rng: np.random.Generator, img_size: int, crop_prob: float = 0.5
) -> np.ndarray:
    if rng.random() < crop_prob:
        img = _random_resized_crop(img, rng, img_size)
    img = _resize(img, (img_size, img_size))
    if rng.random() < 0.5:
        img = img[:, ::-1]
    return np.ascontiguousarray(img, dtype=np.float32) / 255.0


class ImageFolderDataset:
    """Images under class subdirectories; targets = sorted-class index."""

    def __init__(self, root: str):
        self.samples: list[str] = []
        self.targets: list[int] = []
        classes = sorted(
            d.name for d in Path(root).iterdir() if d.is_dir()
        )
        self.classes = classes
        for idx, cls in enumerate(classes):
            files = sorted(list_images(str(Path(root) / cls)))
            self.samples.extend(files)
            self.targets.extend([idx] * len(files))

    def __len__(self):
        return len(self.samples)


class ReferenceDataset(ImageFolderDataset):
    """Adds a shuffled second image from the same domain per sample
    (data_loader.py:57-66)."""

    def __init__(self, root: str, seed: int = 0):
        super().__init__(root)
        rng = np.random.default_rng(seed)
        self.samples2: list[str] = []
        targets = np.asarray(self.targets)
        samples = np.asarray(self.samples)
        for idx in range(len(self.classes)):
            cls_files = samples[targets == idx]
            self.samples2.extend(rng.permutation(cls_files).tolist())


def _balanced_indices(targets: list[int], rng: np.random.Generator, n: int) -> np.ndarray:
    counts = np.bincount(targets)
    weights = (1.0 / counts)[targets]
    p = weights / weights.sum()
    return rng.choice(len(targets), size=n, replace=True, p=p)


class FaceBatcher:
    """Infinite training-batch iterator with background prefetch.

    Yields dicts with keys x_src, y_src, x_ref, x_ref2, y_ref, z_trg,
    z_trg2 — the reference InputFetcher 'train' payload
    (data_loader.py:219-227) — as numpy arrays (NHWC, [0,1]).
    """

    def __init__(
        self,
        src_root: str,
        ref_root: str,
        img_size: int = 256,
        batch_size: int = 8,
        latent_dim: int = 16,
        crop_prob: float = 0.5,
        seed: int = 0,
        prefetch: int = 2,
        use_native: bool | None = None,
        process_index: int = 0,
        process_count: int = 1,
    ):
        """``batch_size`` is the global batch; with ``process_count`` > 1
        this process builds ``batch_size // process_count`` samples a step
        from a process-decorrelated random stream (independent per-rank
        sampling).  One process, the default, keeps the seed's stream."""
        if batch_size % process_count != 0:
            raise ValueError(
                f"process count {process_count} must divide batch_size "
                f"{batch_size}"
            )
        self.src = ImageFolderDataset(src_root)
        self.ref = ReferenceDataset(ref_root, seed=seed)
        if use_native is None:
            from . import native

            use_native = native.available()
        self._native = use_native
        self.img_size = img_size
        self.batch_size = batch_size // process_count
        self.latent_dim = latent_dim
        self.crop_prob = crop_prob
        # Single-process keeps the historical stream; multi-host
        # decorrelates per process (spawn-key style seeding).
        self.rng = np.random.default_rng(
            seed if process_count == 1 else [seed, process_index]
        )
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _transform_many(self, paths: list[str]) -> np.ndarray:
        """Decode + crop/resize/flip/normalize a list of images.

        Uses the native C++ thread-pool path (bit-exact with PIL) when
        the library built; falls back to per-image PIL otherwise.  The
        random crop/flip decisions are always drawn host-side from the
        same generator, so both paths consume identical randomness.
        """
        rng = self.rng
        s = self.img_size
        if not self._native:
            return np.stack(
                [train_transform(_load_rgb(p), rng, s, self.crop_prob) for p in paths]
            )
        from . import native

        # Fully-native path when every file is a JPEG and the library
        # built with libjpeg: bytes -> (decode + crop/resize/flip)
        # entirely inside the C++ pool.  The crop geometry needs only
        # (H, W), which a header-only parse provides, so the random
        # stream is drawn identically to the PIL path.
        if native.has_jpeg() and all(
            p.rsplit(".", 1)[-1].lower() in ("jpg", "jpeg") for p in paths
        ):
            datas, crops, flips, bad = [], [], [], []
            for i, p in enumerate(paths):
                with open(p, "rb") as f:
                    data = f.read()
                try:
                    hw = native.jpeg_dims(data)
                except ValueError:
                    bad.append(i)
                    hw = (1, 1)
                crop = (0, 0, hw[0], hw[1])
                if rng.random() < self.crop_prob:
                    crop = _sample_crop_box(hw, rng)
                datas.append(data)
                crops.append(crop)
                flips.append(rng.random() < 0.5)
            out, ok = native.batch_decode_transform(
                datas, np.asarray(crops, np.int32), (s, s), np.asarray(flips)
            )
            # A header-parse failure lands in both ``bad`` and ``~ok`` —
            # dedupe so the PIL fallback decodes (and draws RNG for)
            # each slot exactly once.
            for i in sorted(set(np.nonzero(~ok)[0].tolist()) | set(bad)):
                # Corrupt stream: decode via PIL (raises loudly on a
                # truly broken file — the reference loader's behavior).
                out[i] = train_transform(_load_rgb(paths[i]), rng, s, 0.0)
            return out

        imgs, crops, flips = [], [], []
        for p in paths:
            img = _load_rgb(p)
            h, w = img.shape[:2]
            crop = (0, 0, h, w)
            if rng.random() < self.crop_prob:
                crop = _sample_crop_box((h, w), rng)
            imgs.append(img)
            crops.append(crop)
            flips.append(rng.random() < 0.5)
        return native.batch_transform(
            imgs, np.asarray(crops, np.int32), (s, s), np.asarray(flips)
        )

    def _make_batch(self) -> dict:
        rng = self.rng
        b = self.batch_size
        si = _balanced_indices(self.src.targets, rng, b)
        ri = _balanced_indices(self.ref.targets, rng, b)
        x_src = self._transform_many([self.src.samples[i] for i in si])
        x_ref = self._transform_many([self.ref.samples[i] for i in ri])
        x_ref2 = self._transform_many([self.ref.samples2[i] for i in ri])
        return dict(
            x_src=x_src,
            y_src=np.asarray([self.src.targets[i] for i in si], np.int32),
            x_ref=x_ref,
            x_ref2=x_ref2,
            y_ref=np.asarray([self.ref.targets[i] for i in ri], np.int32),
            z_trg=rng.standard_normal((b, self.latent_dim)).astype(np.float32),
            z_trg2=rng.standard_normal((b, self.latent_dim)).astype(np.float32),
        )

    def _worker(self):
        while not self._stop.is_set():
            try:
                self._q.put(self._make_batch(), timeout=1.0)
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=10.0)


def eval_batches(
    root: str,
    img_size: int = 256,
    batch_size: int = 32,
    imagenet_normalize: bool = False,
    shuffle: bool = False,
    seed: int = 0,
) -> Iterator[np.ndarray]:
    """Finite eval iterator (reference get_eval_loader semantics:
    optional resize-to-299 + ImageNet normalization for Inception)."""
    files = sorted(list_images(root))
    order = np.arange(len(files))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for lo in range(0, len(files), batch_size):
        imgs = []
        for i in order[lo : lo + batch_size]:
            img = _resize(_load_rgb(files[i]), (img_size, img_size))
            if imagenet_normalize:
                img = _resize(img, (299, 299))
                x = img.astype(np.float32) / 255.0
                x = (x - IMAGENET_MEAN) / IMAGENET_STD
            else:
                x = img.astype(np.float32) / 255.0
            imgs.append(x)
        yield np.stack(imgs)
