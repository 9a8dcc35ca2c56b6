"""The port's LPIPS (metrics/lpips.py) against the JAX package's, on the
same weights carried over by ``utils/jax_params.py``: the distance and
its gradient, in f32; and the reference's own files (a torchvision
AlexNet state_dict and ``lpips_weights.ckpt``) loading straight into
the port's module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppvision_tpu.metrics.lpips import LPIPS as JLPIPS
from ppvision_tpu_torch.metrics.lpips import ALEX_CHANNELS, LPIPS, lpips_state_dict_from_reference
from ppvision_tpu_torch.utils import jax_params

from .torch_parity import numpy_tree


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    model = JLPIPS()
    params = jax.jit(model.init)(jax.random.key(7), jnp.asarray(x[:1]), jnp.asarray(y[:1]))["params"]
    # Learned weights off their init of ones, so the per-layer weighting counts.
    params = dict(params)
    for i, c in enumerate(ALEX_CHANNELS):
        params[f"lin_{i}"] = jnp.asarray(rng.uniform(0, 1, (c, 1)).astype(np.float32))
    value, grad = jax.jit(jax.value_and_grad(lambda b: model.apply({"params": params}, jnp.asarray(x), b)))(
        jnp.asarray(y)
    )
    return x, y, numpy_tree(params), float(value), np.asarray(grad)


def test_lpips_matches_jax(setup):
    x, y, params, want, want_grad = setup
    port = LPIPS()
    port.load_state_dict(jax_params.lpips_state_dict(params))
    yt = torch.from_numpy(y).requires_grad_(True)
    got = port(torch.from_numpy(x), yt)
    (grad,) = torch.autograd.grad(got, yt)
    # f32 conv sums in another order through five layers.
    got = float(got.detach())
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    np.testing.assert_allclose(grad.numpy(), want_grad, rtol=1e-3, atol=1e-4 * float(np.abs(want_grad).max()))
    with torch.no_grad():
        assert float(port(torch.from_numpy(x), torch.from_numpy(x))) == 0.0


def test_reference_files_load_into_the_port(setup):
    """torchvision names (``features.N``) and the reference's LPIPS
    weights map onto the port's keys and give the same distance."""
    x, y, params, want, _ = setup
    sd = jax_params.lpips_state_dict(params)
    alexnet = {k.replace("alexnet.layers.", "features."): v for k, v in sd.items() if k.startswith("alexnet.")}
    lin = {k: v for k, v in sd.items() if k.startswith("lpips_weights.")}
    port = LPIPS()
    port.load_state_dict(lpips_state_dict_from_reference(alexnet, lin), strict=True)
    assert set(port.state_dict()) == set(sd)
    got = float(port(torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(got - want) <= 1e-5 * abs(want)
