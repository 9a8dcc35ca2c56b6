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


def test_pairwise_lpips_matches_jax(setup):
    """``make_pairwise_lpips_fn`` (AlexNet once over the R*B outputs, the
    C(R, 2) pairs in ``np.triu_indices`` order) and
    ``calculate_lpips_given_images`` against the JAX package's."""
    from ppvision_tpu.metrics.lpips import calculate_lpips_given_images as j_mean
    from ppvision_tpu.metrics.lpips import make_pairwise_lpips_fn as j_pairwise
    from ppvision_tpu_torch.metrics.lpips import calculate_lpips_given_images, make_pairwise_lpips_fn

    _, _, params, _, _ = setup
    fakes = np.random.default_rng(2).uniform(-1, 1, (4, 2, 64, 64, 3)).astype(np.float32)
    port = LPIPS()
    port.load_state_dict(jax_params.lpips_state_dict(params))
    want = np.asarray(j_pairwise(params, 4)(jnp.asarray(fakes)))
    got = make_pairwise_lpips_fn(port, 4)(torch.from_numpy(fakes)).numpy()
    assert got.shape == want.shape == (6,)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with torch.no_grad():
        i, j = np.triu_indices(4, k=1)
        assert abs(got[2] - float(port(torch.from_numpy(fakes[i[2]]), torch.from_numpy(fakes[j[2]])))) <= 1e-5 * got[2]
    want = j_mean(JLPIPS(), params, [jnp.asarray(f) for f in fakes[:3]])
    assert abs(calculate_lpips_given_images(port, [torch.from_numpy(f) for f in fakes[:3]]) - want) <= 1e-5 * want
