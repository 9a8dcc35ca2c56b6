"""Port kernel 2 (ops/denseblock.py) against the JAX package's
``dense_block_ref``: the whole FAN DenseConvBlock in bf16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppvision_tpu.ops.denseblock import dense_block_ref as jax_dense_block_ref
from ppvision_tpu_torch.ops.denseblock import dense_block_ref, fused_dense_block


def _mk(seed, b, h, f):
    rng = np.random.default_rng(seed)
    half, quarter = f // 2, f // 4
    x = rng.standard_normal((b, h, h, f)).astype(np.float32)
    ks = [
        (rng.standard_normal(s) * 0.1).astype(np.float32)
        for s in ((3, 3, f, half), (3, 3, half, quarter), (3, 3, quarter, quarter))
    ]
    bns = [
        ((1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
         (0.1 * rng.standard_normal(c)).astype(np.float32))
        for c in (f, half, quarter)
    ]
    return x, ks, bns


def _torch_args(x, ks, bns, dev="cpu"):
    bf = torch.bfloat16
    return (
        torch.from_numpy(x).to(dev, bf),
        *[torch.from_numpy(k).to(dev, bf) for k in ks],
        *[(torch.from_numpy(m).to(dev), torch.from_numpy(a).to(dev)) for m, a in bns],
    )


# rel < 2e-2: bf16 convs whose f32 sums run in another order, the JAX
# package's own fused-vs-unfused bound (tests/test_denseblock.py).
@pytest.mark.parametrize("b,h,f", [(2, 8, 256), (2, 8, 128), (1, 5, 128)])
def test_dense_block_matches_jax(b, h, f):
    x, ks, bns = _mk(0, b, h, f)
    bf = jnp.bfloat16
    want = jax_dense_block_ref(
        jnp.asarray(x, bf), *[jnp.asarray(k, bf) for k in ks],
        *[(jnp.asarray(m), jnp.asarray(a)) for m, a in bns],
    )
    want = np.asarray(want.astype(jnp.float32))
    got = fused_dense_block(*_torch_args(x, ks, bns)).float().numpy()
    assert got.shape == want.shape
    rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-8)
    assert rel < 2e-2, rel


def test_cpu_tensors_take_the_plain_version():
    x, ks, bns = _mk(1, 1, 4, 128)
    args = _torch_args(x, ks, bns)
    before = fused_dense_block.launches
    assert torch.equal(fused_dense_block(*args), dense_block_ref(*args))
    assert fused_dense_block.launches == before

