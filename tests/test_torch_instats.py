"""Port kernel 3 (ops/instats.py) against the JAX package's
``_moments_ref``: per-(sample, channel) E[x] and E[x^2]."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppvision_tpu.ops.instats import _moments_ref as jax_moments
from ppvision_tpu_torch.ops.instats import instance_moments


# atol 1e-5: f32 means of O(1) values summed in another order (the JAX
# package's own interpret-vs-jnp bound, tests/test_instats.py).
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(4, 8, 8, 128), (2, 16, 16, 64), (3, 5, 7, 48)])
def test_moments_match_jax(shape, dtype):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jm, jm2 = jax_moments(jnp.asarray(x, jnp.dtype(dtype)))
    m, m2 = instance_moments(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert m.dtype == m2.dtype == torch.float32 and m.shape == (shape[0], shape[-1])
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_allclose(m2.numpy(), np.asarray(jm2), atol=1e-5)

