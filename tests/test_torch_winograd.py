"""Port kernel 4 (ops/winograd.py::conv3x3) against the JAX package's
``_lax_conv3x3``: stride-1 SAME 3x3 conv, bf16 NHWC x HWIO."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppvision_tpu.ops.winograd import _lax_conv3x3
from ppvision_tpu_torch.ops.winograd import conv3x3, conv3x3_supported


def _mk(seed, b, h, w, c, k):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    ker = (rng.standard_normal((3, 3, c, k)) * 0.05).astype(np.float32)
    return x, ker


# Error scale of a direct bf16 conv, max|diff| / max|ref| < 2e-2, the
# JAX package's own bound (tests/test_winograd.py).
@pytest.mark.parametrize("shape", [(2, 8, 16, 128, 128), (1, 32, 16, 128, 256), (4, 4, 32, 256, 128)])
def test_conv3x3_matches_jax(shape):
    x, ker = _mk(0, *shape)
    want = np.asarray(_lax_conv3x3(jnp.asarray(x, jnp.bfloat16), jnp.asarray(ker)).astype(jnp.float32))
    got = conv3x3(torch.from_numpy(x).bfloat16(), torch.from_numpy(ker).bfloat16()).float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() / (np.abs(want).max() + 1e-9) < 2e-2


def test_f32_plain_path_is_the_plain_conv():
    x, ker = _mk(1, 2, 8, 16, 8, 8)
    want = np.asarray(_lax_conv3x3(jnp.asarray(x), jnp.asarray(ker)))
    got = conv3x3(torch.from_numpy(x), torch.from_numpy(ker)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_kernel_gate():
    x = torch.zeros((2, 8, 8, 128), dtype=torch.bfloat16)
    assert conv3x3_supported(x, 128)
    assert conv3x3_supported(x[..., :48], 16)
    assert not conv3x3_supported(x[..., :3], 128)  # the RGB stems stay F.conv2d
    assert not conv3x3_supported(x.float(), 128)

