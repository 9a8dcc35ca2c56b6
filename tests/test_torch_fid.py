"""The port's FID (metrics/fid.py) against the JAX package's: InceptionV3
on weights carried from the port's state_dict through the JAX package's
own importer (``inception_variables_from_torch``), the Frechet distance
on the same activations, and the loading of a torchvision-named
state_dict with its ``AuxLogits`` and ``fc`` entries left out."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppvision_tpu.metrics import fid as jfid
from ppvision_tpu.utils.torch_import import inception_variables_from_torch
from ppvision_tpu_torch.metrics import fid


def randomize_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded weights and BatchNorm statistics off their defaults, so the
    running mean, variance and affine terms all count."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if not t.dtype.is_floating_point:
                continue
            u = torch.rand(t.shape, generator=g)
            if name.endswith("running_var"):
                t.copy_(0.5 + u)
            elif t.ndim == 1 and name.endswith("weight"):
                t.copy_(0.75 + 0.5 * u)
            elif t.ndim == 1:
                t.copy_(0.2 * (u - 0.5))
            else:
                t.copy_(torch.randn(t.shape, generator=g) / np.sqrt(t[0].numel()))
    return module


@pytest.fixture(scope="module")
def inception():
    return randomize_(fid.InceptionV3(), 0).eval()


def _sd_numpy(module) -> dict:
    return {k: v.numpy() for k, v in module.state_dict().items()}


def test_inception_matches_jax(inception):
    """2x107x107x3 (75^2 is the least Inception takes), f32: within atol
    1e-5, rtol 1e-4, tighter than ``tests/test_metric_net_parity.py``'s
    importer bound (2e-3, 1e-3); measured 1.3e-7 on outputs up to 0.36."""
    x = np.random.default_rng(0).standard_normal((2, 107, 107, 3)).astype(np.float32)
    variables = inception_variables_from_torch(_sd_numpy(inception))
    want = np.asarray(jax.jit(jfid.InceptionV3().apply)(variables, jnp.asarray(x)))
    got = inception(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 2048) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    acts = fid.collect_activations(inception, [x[:1], x[1:], x[:0]])
    np.testing.assert_array_equal(acts, np.concatenate([inception(torch.from_numpy(x[i : i + 1])).detach().numpy()
                                                        for i in range(2)]))


def test_frechet_distance_equals_jax():
    rng = np.random.default_rng(1)
    real = rng.standard_normal((40, 16))
    fake = 0.5 + 1.2 * rng.standard_normal((30, 16))
    assert fid.fid_from_activations(real, fake) == jfid.fid_from_activations(real, fake)
    # Rank-deficient covariances (fewer samples than dimensions).
    real, fake = rng.standard_normal((5, 32)), rng.standard_normal((6, 32))
    got = fid.frechet_distance(*fid.compute_statistics(real), *fid.compute_statistics(fake))
    assert got == jfid.frechet_distance(*jfid.compute_statistics(real), *jfid.compute_statistics(fake))
    assert np.isfinite(got)


def test_torchvision_state_dict_loads_without_auxlogits_and_fc(inception):
    sd = dict(inception.state_dict())
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    sd["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 2048), torch.zeros(1000)
    port = fid.InceptionV3()
    port.load_state_dict(sd)
    assert all(torch.equal(v, sd[k]) for k, v in port.state_dict().items())
    del sd["Mixed_7c.branch_pool.bn.running_var"]
    with pytest.raises(RuntimeError, match="Missing key"):
        fid.InceptionV3().load_state_dict(sd)
