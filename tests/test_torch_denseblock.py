"""Port kernel 2 (ops/denseblock.py) against the JAX package's
``dense_block_ref``: the whole FAN DenseConvBlock in bf16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppvision_tpu.ops.denseblock import dense_block_ref as jax_dense_block_ref
from ppvision_tpu_torch.models.fan import DenseConvBlock
from ppvision_tpu_torch.ops.denseblock import dense_block_ref, fused_dense_block, pack_dense_bn
from ppvision_tpu_torch.ops.winograd import pack_conv3x3_weight, unpack_conv3x3_weight


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
# package's own fused-vs-unfused bound (tests/test_denseblock.py).  FAN's
# smallest block (4^2 at F = 256) and a wider F = 128 image among them.
@pytest.mark.parametrize("b,h,f", [(2, 8, 256), (2, 8, 128), (1, 5, 128), (2, 4, 256), (1, 16, 128)])
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



@pytest.mark.parametrize("f", [128, 256])
def test_packed_kernels_round_trip(f):
    _, ks, _ = _mk(2, 1, 4, f)
    for k in ks:
        hwio = torch.from_numpy(k).to(torch.bfloat16)
        c, kout = hwio.shape[2:]
        packed = pack_conv3x3_weight(hwio)
        assert packed.shape == (9, -(-c // 64), kout, 8, 8)
        assert torch.equal(unpack_conv3x3_weight(packed, c), hwio)


def test_packed_arguments_give_the_same_bits():
    x, ks, bns = _mk(3, 2, 6, 128)
    x, *rest = _torch_args(x, ks, bns)
    hwio, pairs = rest[:3], rest[3:]
    want = fused_dense_block(x, *hwio, *pairs)
    packed = [pack_conv3x3_weight(k) for k in hwio]
    assert torch.equal(fused_dense_block(x, *packed, pack_dense_bn(pairs, 128)), want)


# DenseConvBlock keeps its kernel arguments (packed weights, BN pack) per
# version of its weights and BN entries: an in-place edit must reach the
# output, bit for bit what a module built from the edited state gives.
@pytest.mark.parametrize("edit", ["conv2.weight", "bn1.running_mean", "bn3.running_var", "bn2.weight"])
def test_dense_conv_block_follows_in_place_edits(edit):
    torch.manual_seed(0)
    blk = DenseConvBlock(128, 128, dtype=torch.bfloat16)
    with torch.no_grad():
        for bn in (blk.bn1, blk.bn2, blk.bn3):
            bn.running_mean.normal_()
            bn.running_var.uniform_(0.5, 2.0)
            bn.weight.normal_(1.0, 0.1)
            bn.bias.normal_(0.0, 0.1)
    x = torch.randn((2, 128, 6, 6)).to(torch.bfloat16)
    before = blk(x)
    assert torch.equal(blk(x), before)
    with torch.no_grad():
        blk.state_dict(keep_vars=True)[edit].mul_(1.5)
    after = blk(x)
    fresh = DenseConvBlock(128, 128, dtype=torch.bfloat16)
    fresh.load_state_dict(blk.state_dict())
    assert not torch.equal(after, before)
    assert torch.equal(after, fresh(x))
