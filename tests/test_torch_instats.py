"""Port kernel 3 (ops/instats.py) against the JAX package's
``_moments_ref``: per-(sample, channel) E[x] and E[x^2]; and the
wrapper's split planner."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppvision_tpu.ops.instats import _moments_ref as jax_moments
from ppvision_tpu_torch.ops.instats import (
    FILL_BLOCKS,
    MAX_CHUNK,
    MIN_CHUNK,
    MIN_SLICE,
    SPREAD_BLOCKS,
    instance_moments,
    plan_split,
)


# atol 1e-5: f32 means of O(1) values summed in another order (the JAX
# package's own interpret-vs-jnp bound, tests/test_instats.py).
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(4, 8, 8, 128), (2, 16, 16, 64), (3, 5, 7, 48), (2, 32, 32, 512)])
def test_moments_match_jax(shape, dtype):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jm, jm2 = jax_moments(jnp.asarray(x, jnp.dtype(dtype)))
    m, m2 = instance_moments(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert m.dtype == m2.dtype == torch.float32 and m.shape == (shape[0], shape[-1])
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_allclose(m2.numpy(), np.asarray(jm2), atol=1e-5)


# (B, H*W, C, bytes an element): the de-id path's seven shapes, the
# video path's at B = 16, 8 and 248, one image of 256^2, a C that is not
# a multiple of 8, f32, images under and over twice MIN_CHUNK, and 4096
# channels.
PLAN_SHAPES = [
    (8, 128 * 128, 128, 2), (8, 64 * 64, 128, 2), (8, 64 * 64, 256, 2), (8, 32 * 32, 256, 2),
    (8, 32 * 32, 512, 2), (8, 16 * 16, 512, 2), (8, 8 * 8, 512, 2), (16, 256 * 256, 64, 2),
    (16, 128 * 128, 128, 2), (1, 256 * 256, 64, 2), (3, 5 * 7, 48, 2), (2, 61 * 67, 7, 2),
    (4, 64 * 64, 64, 4), (16, 8 * 8, 512, 2), (17, 8 * 8, 512, 2), (1, 1, 1, 2),
    (8, 256 * 256, 64, 2), (8, 128 * 128, 64, 2), (248, 256 * 256, 64, 2), (248, 128 * 128, 128, 2),
    (248, 16 * 16, 512, 2), (248, 8 * 8, 512, 2), (2, 96 * 96, 7, 2), (2, 97 * 97, 7, 2),
    (8, 16 * 16, 248, 2), (8, 16 * 16, 264, 2), (2, 16 * 16, 4096, 2), (264, 2 * 2, 4096, 2),
    (8, 45 * 45, 512, 2), (8, 46 * 46, 512, 2), (5, 33 * 33, 512, 2), (3, 300 * 300, 24, 4),
]


@pytest.mark.parametrize("b,hw,c,esize", PLAN_SHAPES)
def test_split_plan_covers_each_image(b, hw, c, esize):
    s, chunk, slices = plan_split(b, hw, c, esize)
    assert s >= 1 and chunk >= 1 and slices >= 1
    # Every chunk holds whole pixels and none is empty: S - 1 full
    # chunks and a last one of 1..chunk pixels cover H*W exactly.
    assert (s - 1) * chunk < hw <= s * chunk
    plan_split.cache_clear()
    assert plan_split(b, hw, c, esize) == (s, chunk, slices)  # a function of the shape alone
    row = c * esize
    if slices > 1:
        # 16-byte-aligned slices of at least MIN_SLICE bytes a pixel, no
        # more than reach SPREAD_BLOCKS, each read whole by one block.
        assert row % (16 * slices) == 0 and row // slices >= MIN_SLICE
        assert b * slices < 2 * SPREAD_BLOCKS and s == 1
    if hw * row // slices <= MAX_CHUNK:
        assert s == 1
    else:
        # Unsliced chunks of MIN_CHUNK..MAX_CHUNK bytes (give or take a
        # pixel), FILL_BLOCKS of them unless MIN_CHUNK caps S.
        assert slices == 1 and MIN_CHUNK <= chunk * row <= MAX_CHUNK + row
        assert b * s >= FILL_BLOCKS // 2 or chunk * row < 2 * MIN_CHUNK


# (B, H*W, C) -> (S, chunk, slices) at the shapes the card tests hold
# either side of a boundary (tests/test_torch_cuda.py).
BOUNDARY_PLANS = {
    (8, 8 * 8, 512): (1, 64, 16),  # 55 a served step: 16 slices of 64 bytes, 128 blocks
    (17, 8 * 8, 512): (1, 64, 8),  # 136 blocks: 8 slices reach SPREAD_BLOCKS
    (248, 8 * 8, 512): (1, 64, 1),  # 248 blocks, no slice
    (248, 16 * 16, 512): (2, 128, 1),  # 256 KB an image: two chunks
    (16, 256 * 256, 64): (64, 1024, 1),
    (8, 128 * 128, 128): (33, 497, 1),
    (8, 45 * 45, 512): (1, 2025, 16),  # a 126.6 KB slice: one block
    (8, 46 * 46, 512): (33, 65, 1),  # a 132 KB slice: chunks instead
    (8, 16 * 16, 248): (1, 256, 1),  # 124 KB an image: one block, no slice (31 groups)
    (8, 16 * 16, 264): (1, 256, 11),  # 33 groups in 11 slices of 3: one of 256 threads idle
    (264, 4 * 4, 264): (1, 16, 1),  # 33 groups unsliced: 25 of 256 threads idle
    (8, 64 * 64, 256): (1, 64 * 64, 16),  # 32-byte slices, 128 KB each
    (2, 96 * 96, 7): (1, 96 * 96, 1),  # 126 KB, unaligned pixels: one block
    (2, 97 * 97, 7): (2, 4705, 1),  # 129 KB: two chunks
    (264, 2 * 2, 4096): (1, 4, 1),  # 512 groups, two passes a block
}


@pytest.mark.parametrize("shape", list(BOUNDARY_PLANS))
def test_split_plan_at_the_card_tests_boundaries(shape):
    assert plan_split(*shape, 2) == BOUNDARY_PLANS[shape]


def test_split_plan_at_the_paths_small_and_large_shapes():
    # The 8^2 launches (55 a served step) are one chunk an image, sliced
    # so the card has blocks, and write their means directly; the large
    # ones fill the card with unsliced chunks of at most MAX_CHUNK.
    for b in (8, 16, 248):
        s, chunk, slices = plan_split(b, 64, 512, 2)
        assert s == 1 and chunk == 64 and b * slices >= SPREAD_BLOCKS
    for b, hw, c in ((16, 256 * 256, 64), (8, 128 * 128, 128), (248, 256 * 256, 64), (8, 256 * 256, 64)):
        s, chunk, slices = plan_split(b, hw, c, 2)
        assert slices == 1 and b * s >= FILL_BLOCKS and chunk * c * 2 <= MAX_CHUNK
    # Pixels that are not 16-byte aligned are never sliced.
    assert plan_split(8, 64, 500, 2) == (1, 64, 1)
