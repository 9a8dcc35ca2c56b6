"""Port kernel 4 (ops/winograd.py::conv3x3) against the JAX package's
``_lax_conv3x3`` and its Pallas kernel in interpret mode: stride-1 SAME
3x3 conv, bf16 NHWC x HWIO; and the weight packing the kernel reads."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppvision_tpu.ops.winograd import _lax_conv3x3, _winograd_impl
from ppvision_tpu_torch.ops.winograd import (
    conv3x3,
    conv3x3_supported,
    pack_conv3x3_weight,
    unpack_conv3x3_weight,
)


def _mk(seed, b, h, w, c, k):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    ker = (rng.standard_normal((3, 3, c, k)) * 0.05).astype(np.float32)
    return x, ker


# Error scale of a direct bf16 conv, max|diff| / max|ref| < 2e-2, the
# JAX package's own bound (tests/test_winograd.py).
@pytest.mark.parametrize(
    "shape", [(2, 8, 16, 128, 128), (1, 32, 16, 128, 256), (4, 4, 32, 256, 128), (2, 16, 16, 64, 64)]
)
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


def test_conv3x3_matches_pallas_interpret():
    """The JAX package's own Winograd kernel, run as tests/test_winograd.py
    runs it on the CPU, against the port on the packed weight."""
    x, ker = _mk(2, 2, 8, 16, 128, 128)
    want = _winograd_impl(jnp.asarray(x, jnp.bfloat16), jnp.asarray(ker), interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    w = pack_conv3x3_weight(torch.from_numpy(ker).bfloat16())
    got = conv3x3(torch.from_numpy(x).bfloat16(), w).float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() / (np.abs(want).max() + 1e-9) < 2e-2


def test_weight_packing_layout():
    """The packed copy unpacks to the HWIO kernel exactly, and elements sit
    where the stated rule puts them: packed[t, s, n, g ^ (n % 8), e] =
    w[t // 3, t % 3, 64 s + 8 g + e, n], zeros past C."""
    c, k = 48, 80
    w = torch.from_numpy(np.random.default_rng(3).standard_normal((3, 3, c, k)).astype(np.float32)).bfloat16()
    p = pack_conv3x3_weight(w)
    assert p.shape == (9, 1, k, 8, 8) and p.is_contiguous()
    assert torch.equal(unpack_conv3x3_weight(p, c), w)
    for t, n, g, e in [(0, 0, 0, 0), (4, 29, 3, 2), (8, 79, 5, 7), (5, 6, 1, 6)]:
        assert p[t, 0, n, g ^ (n % 8), e] == w[t // 3, t % 3, 8 * g + e, n]
    assert not p[:, 0, 13, [6 ^ 5, 7 ^ 5]].any()  # channels 48..63 of row 13
    # Flat: a (tap, 64-channel) block is K rows of 128 bytes.
    assert p.reshape(-1)[((4 * k + 29) * 8 + (3 ^ 5)) * 8 + 2] == w[1, 1, 26, 29]
    w2 = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 3, 160, 16)).astype(np.float32))
    p2 = pack_conv3x3_weight(w2)
    assert p2.shape == (9, 3, 16, 8, 8) and torch.equal(unpack_conv3x3_weight(p2, 160), w2)
    assert p2[7, 2, 9, 2 ^ 1, 3] == w2[2, 1, 128 + 16 + 3, 9]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 5, 7, c)).astype(np.float32)).bfloat16()
    assert torch.equal(conv3x3(x, p), conv3x3(x, w))
    with pytest.raises(ValueError):
        pack_conv3x3_weight(w[:, :, :40])
