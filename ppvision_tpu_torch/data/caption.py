"""Captioning data pipeline: Karpathy-split preprocessing + HDF5 dataset.

A copy of ``ppvision_tpu/data/caption.py`` (numpy; h5py and PIL imported
where they are needed), except that ``caption_batches`` shuffles with a
seeded ``torch.Generator`` and runs in one process.  It ports the
reference preprocessing and dataset behavior
(``Image_Caption/utils.py:15-307``, ``Image_Caption/datasets.py:8-63``):

- ``create_input_files`` — Karpathy JSON -> per-split HDF5 of 256^2
  uint8 images (stored NHWC here; the reference stores CHW) + encoded
  captions ``<start> w... <end> <pad>*`` + caption lengths + WORDMAP
  json (ids start at 1; <pad>=0; <unk>/<start>/<end> appended last).
- ``CaptionDataset`` — images scaled to [0,1] float, one (img, caption,
  caplen) per caption; VAL/TEST also yield all captions of the image
  for corpus metrics.
- ``caption_batches`` — shuffled finite epoch iterator of stacked
  numpy batches.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Iterator

import numpy as np
import torch

__all__ = [
    "create_input_files",
    "create_input_files_custom",
    "CaptionDataset",
    "caption_batches",
    "base_name",
]


def base_name(dataset: str, captions_per_image: int, min_word_freq: int) -> str:
    return f"{dataset}_{captions_per_image}_cap_per_img_{min_word_freq}_min_word_freq"


def create_input_files(
    dataset: str,
    karpathy_json_path: str,
    image_folder: str,
    captions_per_image: int,
    min_word_freq: int,
    output_folder: str,
    max_len: int = 100,
    image_size: int = 256,
    seed: int = 123,
) -> None:
    """Build WORDMAP json + per-split HDF5/json files."""
    assert dataset in {"coco", "flickr8k", "flickr30k"}
    with open(karpathy_json_path) as f:
        data = json.load(f)

    splits: dict[str, list] = {"TRAIN": [], "VAL": [], "TEST": []}
    word_freq: Counter = Counter()
    for img in data["images"]:
        captions = []
        for c in img["sentences"]:
            word_freq.update(c["tokens"])
            if len(c["tokens"]) <= max_len:
                captions.append(c["tokens"])
        if not captions:
            continue
        path = (
            os.path.join(image_folder, img["filepath"], img["filename"])
            if dataset == "coco"
            else os.path.join(image_folder, img["filename"])
        )
        split = img["split"]
        if split in ("train", "restval"):
            splits["TRAIN"].append((path, captions))
        elif split == "val":
            splits["VAL"].append((path, captions))
        elif split == "test":
            splits["TEST"].append((path, captions))

    _write_outputs(
        splits, word_freq, dataset, captions_per_image, min_word_freq,
        output_folder, max_len, image_size, seed,
    )


def create_input_files_custom(
    dataset: str,
    karpathy_json_path: str,
    image_folder: str,
    captions_per_image: int,
    min_word_freq: int,
    output_folder: str,
    max_len: int = 100,
    image_size: int = 256,
    seed: int = 123,
    train_limit: int = 500,
) -> None:
    """Lab-subset builder (reference ``utils.py::create_input_files_custom``
    ~:153-307): ONLY the Karpathy train split is used — the first
    ``train_limit`` readable images become TRAIN and the remainder VAL;
    no TEST files are written.  The word map still counts every caption
    in the JSON, exactly like the reference."""
    from PIL import Image

    assert dataset in {"coco", "flickr8k", "flickr30k"}
    with open(karpathy_json_path) as f:
        data = json.load(f)

    splits: dict[str, list] = {"TRAIN": [], "VAL": []}
    word_freq: Counter = Counter()
    n_readable = 0
    for img in data["images"]:
        captions = []
        for c in img["sentences"]:
            word_freq.update(c["tokens"])
            if len(c["tokens"]) <= max_len:
                captions.append(c["tokens"])
        if not captions or img["split"] != "train":
            continue
        path = (
            os.path.join(image_folder, img["filepath"], img["filename"])
            if dataset == "coco"
            else os.path.join(image_folder, img["filename"])
        )
        # Readability gates the TRAIN/VAL cut (reference ~:208-218:
        # ``limit`` only advances past images imread can open).
        try:
            with Image.open(path) as im:
                im.verify()
        except Exception:  # noqa: BLE001
            continue
        split = "TRAIN" if n_readable < train_limit else "VAL"
        splits[split].append((path, captions))
        n_readable += 1

    _write_outputs(
        splits, word_freq, dataset, captions_per_image, min_word_freq,
        output_folder, max_len, image_size, seed,
    )


def _write_outputs(
    splits: dict[str, list],
    word_freq: Counter,
    dataset: str,
    captions_per_image: int,
    min_word_freq: int,
    output_folder: str,
    max_len: int,
    image_size: int,
    seed: int,
) -> None:
    """Word map + per-split HDF5/caption/caplen files (shared tail of
    both builders, reference utils.py:60-148 / ~:230-307)."""
    import h5py
    from PIL import Image

    words = [w for w in word_freq if word_freq[w] > min_word_freq]
    word_map = {w: i + 1 for i, w in enumerate(words)}
    word_map["<unk>"] = len(word_map) + 1
    word_map["<start>"] = len(word_map) + 1
    word_map["<end>"] = len(word_map) + 1
    word_map["<pad>"] = 0

    base = base_name(dataset, captions_per_image, min_word_freq)
    os.makedirs(output_folder, exist_ok=True)
    with open(os.path.join(output_folder, f"WORDMAP_{base}.json"), "w") as f:
        json.dump(word_map, f)

    rng = np.random.default_rng(seed)
    for split, items in splits.items():
        # Corrupt-image skip (reference utils.py:208-219): drop unreadable
        # files with a warning instead of crashing the whole build.
        ok_items = []
        for path, caps in items:
            try:
                with Image.open(path) as im:
                    im.verify()
                ok_items.append((path, caps))
            except Exception as e:  # noqa: BLE001 — any decode failure
                import sys

                print(f"WARNING: skipping corrupt image {path}: {e}", file=sys.stderr)
        items = ok_items
        h5_path = os.path.join(output_folder, f"{split}_IMAGES_{base}.hdf5")
        with h5py.File(h5_path, "w") as h:
            h.attrs["captions_per_image"] = captions_per_image
            images = h.create_dataset(
                "images", (len(items), image_size, image_size, 3), dtype="uint8"
            )
            enc_captions, caplens = [], []
            for i, (path, caps) in enumerate(items):
                if len(caps) < captions_per_image:
                    caps = caps + [
                        caps[int(rng.integers(len(caps)))]
                        for _ in range(captions_per_image - len(caps))
                    ]
                else:
                    caps = [caps[j] for j in rng.choice(len(caps), captions_per_image, replace=False)]
                with Image.open(path) as im:
                    arr = np.asarray(
                        im.convert("RGB").resize((image_size, image_size), Image.BILINEAR)
                    )
                images[i] = arr
                for c in caps:
                    enc = (
                        [word_map["<start>"]]
                        + [word_map.get(w, word_map["<unk>"]) for w in c]
                        + [word_map["<end>"]]
                        + [word_map["<pad>"]] * (max_len - len(c))
                    )
                    enc_captions.append(enc)
                    caplens.append(len(c) + 2)
        with open(os.path.join(output_folder, f"{split}_CAPTIONS_{base}.json"), "w") as f:
            json.dump(enc_captions, f)
        with open(os.path.join(output_folder, f"{split}_CAPLENS_{base}.json"), "w") as f:
            json.dump(caplens, f)


class CaptionDataset:
    """HDF5-backed caption dataset (one item per caption)."""

    def __init__(self, data_folder: str, base: str, split: str):
        import h5py

        assert split in {"TRAIN", "VAL", "TEST"}
        self.split = split
        self.h = h5py.File(
            os.path.join(data_folder, f"{split}_IMAGES_{base}.hdf5"), "r"
        )
        self.images = self.h["images"]
        self.cpi = int(self.h.attrs["captions_per_image"])
        with open(os.path.join(data_folder, f"{split}_CAPTIONS_{base}.json")) as f:
            self.captions = np.asarray(json.load(f), dtype=np.int32)
        with open(os.path.join(data_folder, f"{split}_CAPLENS_{base}.json")) as f:
            self.caplens = np.asarray(json.load(f), dtype=np.int32)

    def __len__(self):
        return len(self.captions)

    def __getitem__(self, i: int):
        img = self.images[i // self.cpi].astype(np.float32) / 255.0
        if self.split == "TRAIN":
            return img, self.captions[i], self.caplens[i]
        lo = (i // self.cpi) * self.cpi
        allcaps = self.captions[lo : lo + self.cpi]
        return img, self.captions[i], self.caplens[i], allcaps


def caption_batches(
    ds: CaptionDataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
) -> Iterator[dict]:
    """One epoch of stacked batches in the order of a ``torch.randperm``
    from ``seed`` (or in order without ``shuffle``); drops the trailing
    partial batch when shuffling, like the reference's training loader."""
    n = len(ds)
    if shuffle:
        order = torch.randperm(n, generator=torch.Generator().manual_seed(seed)).numpy()
    else:
        order = np.arange(n)
    stop = n - (n % batch_size) if shuffle else n
    for lo in range(0, stop, batch_size):
        items = [ds[int(i)] for i in order[lo : lo + batch_size]]
        batch = dict(
            images=np.stack([it[0] for it in items]),
            captions=np.stack([it[1] for it in items]),
            caption_lengths=np.asarray([it[2] for it in items], np.int32),
        )
        if ds.split != "TRAIN":
            batch["all_captions"] = np.stack([it[3] for it in items])
        yield batch
