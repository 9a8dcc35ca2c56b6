"""Port image ops (ops/image.py, ops/fusedconv.py) against the JAX
package and torch's own ``F.interpolate``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ppvision_tpu.ops import fusedconv as jfc
from ppvision_tpu.ops import image as jim
from ppvision_tpu_torch.ops import fusedconv as tfc
from ppvision_tpu_torch.ops import image as tim


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("out_hw", [(7, 20), (32, 32), (3, 5)])
def test_resize_bilinear_matches_jax_and_interpolate(out_hw, align):
    x = np.random.default_rng(0).standard_normal((2, 10, 13, 3)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tim.resize_bilinear(xt, out_hw, align_corners=align)
    want = np.asarray(jim.resize_bilinear(jnp.asarray(x), out_hw, align_corners=align))
    # Both are the same two-nonzero matrix contractions in f32.
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-6, atol=1e-6)
    ref = F.interpolate(xt, out_hw, mode="bilinear", align_corners=align)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_pool_and_upsample_match_jax(dtype):
    x = np.random.default_rng(1).standard_normal((2, 8, 6, 16)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    # Four taps summed in f32 and rounded once: identical values.
    np.testing.assert_array_equal(
        _nhwc(tim.avg_pool_2x(xt)), np.asarray(jim.avg_pool_2x(jx).astype(jnp.float32))
    )
    np.testing.assert_array_equal(
        _nhwc(tim.upsample_nearest_2x(xt)), np.asarray(jim.upsample_nearest_2x(jx).astype(jnp.float32))
    )


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_fused_resample_convs_match_jax(dtype, tol):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 8, 16)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 16, 24)) * 0.2).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    wt = torch.from_numpy(k).permute(3, 2, 0, 1)  # OIHW f32 master
    for jfn, tfn in ((jfc.conv3x3_nearest_up2x, tfc.conv3x3_nearest_up2x),
                     (jfc.conv3x3_avgpool2x, tfc.conv3x3_avgpool2x)):
        want = np.asarray(jfn(jx, jnp.asarray(k)).astype(jnp.float32))
        got = _nhwc(tfn(xt, wt))
        assert got.shape == want.shape
        # f32: the same sums; bf16: one output rounding, reordered sums.
        assert np.abs(got - want).max() / np.abs(want).max() < tol


def test_up2x_transpose_conv_is_upsample_then_conv():
    """conv_transpose2d flips its kernel where lax.conv_transpose does
    not: the port flips K4 and pads by 1, and the pair must equal the
    unfused nearest-up + SAME conv."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 4, 5, 7)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 4, 3, 3)).astype(np.float32))
    fused = tfc.conv3x3_nearest_up2x(x, w)
    plain = F.conv2d(tim.upsample_nearest_2x(x), w, padding=1)
    assert float((fused - plain).abs().max()) < 1e-5
