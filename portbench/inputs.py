"""Seeded inputs: smooth images and captions, made on the device in a few
calls.  The same seed gives the same inputs."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["smooth_images", "caption_batch", "seed_rng"]


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """A host generator for stream ``stream`` of one run's seed."""
    return np.random.default_rng([int(seed) % (2**63), stream])


def smooth_images(n: int, size: int, seed: int, device, stream: int = 0) -> torch.Tensor:
    """(n, size, size, 3) float32 in [0, 1], on ``device``: 16x16 uniform
    noise from a seeded generator, bicubic upsampled and clamped (face
    sized smooth images; no dataset is read)."""
    g = torch.Generator(device=device).manual_seed((int(seed) * 1000003 + stream) % (2**63))
    base = torch.rand((n, 3, 16, 16), generator=g, device=device)
    img = F.interpolate(base, size=(size, size), mode="bicubic", align_corners=False).clamp(0, 1)
    return img.permute(0, 2, 3, 1).contiguous()


def caption_batch(rng: np.random.Generator, b: int, tokens: int, words: tuple[int, int], vocab: int):
    """``b`` encoded captions ``<start> w... <end> <pad>*`` of ``tokens``
    columns and their lengths in tokens.  The word counts are the same
    multiset in every batch (words[0]..words[1] repeated over the rows),
    in a seeded order; the words are drawn from the map's ordinary
    entries 1..vocab-4 (vocab-3..vocab-1 are <unk>, <start>, <end>; 0 is
    <pad>)."""
    lo, hi = words
    counts = np.resize(np.arange(lo, hi + 1), b)
    rng.shuffle(counts)
    caps = np.zeros((b, tokens), np.int64)
    caps[:, 0] = vocab - 2
    for i, w in enumerate(counts):
        caps[i, 1: w + 1] = rng.integers(1, vocab - 3, w)
        caps[i, w + 1] = vocab - 1
    return caps, (counts + 2).astype(np.int64)
