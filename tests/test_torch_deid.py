"""The whole port de-id slice (camera -> FAN -> StarGAN) against the JAX
package's ``deid_multi_style`` with the same parameters and inputs."""

import jax
import numpy as np
import pytest
import torch

from ppvision_tpu.deid import deid_multi_style as jax_deid_multi_style
from ppvision_tpu_torch.deid import deid_multi_style

from .torch_parity import diff_stats, jax_bundle, torch_bundle, with_dtype

B, R = 3, 2


@pytest.fixture(scope="module")
def runs():
    jb = jax_bundle("float32")
    rng = np.random.default_rng(0)
    xs = rng.random((B, 64, 64, 3)).astype(np.float32)
    xr = rng.random((R, 64, 64, 3)).astype(np.float32)
    yr = np.array([0, 1], np.int32)
    out = {}
    for dtype in ("float32", "bfloat16"):
        b = with_dtype(jb, dtype)
        fn = jax.jit(lambda p: jax_deid_multi_style(b, p, xs, xr, yr))
        out["jax", dtype] = np.asarray(fn(b.params))
        tb = torch_bundle(jb, dtype)
        out["port", dtype] = deid_multi_style(
            tb, torch.from_numpy(xs), torch.from_numpy(xr), torch.from_numpy(yr).long()
        ).numpy()
    return out


def test_deid_multi_style_matches_jax_f32(runs):
    got, want = runs["port", "float32"], runs["jax", "float32"]
    assert got.shape == want.shape == (R, B, 64, 64, 3) and got.dtype == np.float32
    # f32 compute on both sides: FFT and conv sums in another order,
    # carried through the FAN masks and the generator's high-pass skips
    # (outputs reach |8| with random weights).
    assert np.abs(got - want).max() <= 1e-3


def test_deid_multi_style_bf16_within_bf16_noise(runs):
    """bf16 rounds at the same ops on both sides, but with random weights
    a 1-ulp change in one conv sum grows through FAN and the generator as
    far as bf16 itself departs from f32 (JAX's own bf16-vs-f32 gap here is
    ~0.3 at p99).  The port's bf16 output must sit no further from JAX's
    bf16 output than that gap, at p99 and at the max."""
    got = runs["port", "bfloat16"]
    assert np.isfinite(got).all()
    p99, mx = diff_stats(got, runs["jax", "bfloat16"])
    n99, nmx = diff_stats(runs["jax", "bfloat16"], runs["jax", "float32"])
    assert p99 <= 1.5 * n99 and mx <= 1.5 * nmx, (p99, mx, n99, nmx)
    # And it stays as close to the f32 result as JAX's bf16 path does.
    q99, qmx = diff_stats(got, runs["jax", "float32"])
    assert q99 <= 1.5 * n99 and qmx <= 1.5 * nmx, (q99, qmx, n99, nmx)
