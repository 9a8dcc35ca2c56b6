"""Shared helpers of the ``test_torch_*`` parity tests.

The JAX package is the reference: parameters come from its own
initializers (the same keys and code path as ``deid.build_deid``, with
the inits jitted so a test file builds them in seconds), inputs are
made with numpy from a seed, and the port receives the parameters
through ``ppvision_tpu_torch.utils.jax_params``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppvision_tpu.config import CameraConfig, FaceDeIdConfig, ModelConfig
from ppvision_tpu.deid import DeIdBundle, DeIdParams
from ppvision_tpu.models.fan import FAN
from ppvision_tpu.models.stargan import build_gan_models
from ppvision_tpu.optics.camera import CameraSpec, init_camera_params, make_camera_constants

# The test_serve.py config: small widths, every stage of the pipeline.
TINY = dict(img_size=64, style_dim=16, latent_dim=8, max_conv_dim=64, fan_input_size=64)


def jax_cfg(compute_dtype: str = "bfloat16") -> FaceDeIdConfig:
    return FaceDeIdConfig(
        model=ModelConfig(**TINY, compute_dtype=compute_dtype), camera=CameraConfig(n=32)
    )


def torch_cfg(compute_dtype: str = "bfloat16"):
    from ppvision_tpu_torch.config import CameraConfig as TCam
    from ppvision_tpu_torch.config import FaceDeIdConfig as TCfg
    from ppvision_tpu_torch.config import ModelConfig as TModel

    return TCfg(model=TModel(**TINY, compute_dtype=compute_dtype), camera=TCam(n=32))


def jax_bundle(compute_dtype: str = "bfloat16", seed: int = 0, with_fan: bool = True) -> DeIdBundle:
    """``deid.build_deid(jax.random.key(seed), cfg)`` with jitted inits:
    the same keys and initializers, so the same parameters.
    ``with_fan=False`` leaves ``fan_priv`` out (None) for tests of the
    other nets."""
    cfg = jax_cfg(compute_dtype)
    dtype = jnp.dtype(compute_dtype)
    m = cfg.model
    models = build_gan_models(
        img_size=m.img_size, style_dim=m.style_dim, latent_dim=m.latent_dim,
        num_domains=m.num_domains, w_hpf=m.w_hpf, max_conv_dim=m.max_conv_dim, dtype=dtype,
    )
    fan = FAN(dtype=dtype)
    kc, kf, kg, km, ke = jax.random.split(jax.random.key(seed), 5)
    n = m.img_size
    spec = CameraSpec(n=n, zernike_terms=cfg.camera.zernike_terms)
    x = jnp.zeros((1, n, n, 3))
    s = jnp.zeros((1, m.style_dim))
    z = jnp.zeros((1, m.latent_dim))
    y = jnp.zeros((1,), dtype=jnp.int32)
    masks = (jnp.zeros((1, 256, 256, 1)), jnp.zeros((1, 256, 256, 1)))
    params = DeIdParams(
        camera=init_camera_params(kc, spec),
        camera_consts=make_camera_constants(spec),
        fan_priv=jax.jit(fan.init)(kf, jnp.zeros((1, 64, 64, 3)))["params"] if with_fan else None,
        generator=jax.jit(models["generator"].init)(kg, x, s, masks)["params"],
        mapping_network=jax.jit(models["mapping_network"].init)(km, z, y)["params"],
        style_encoder=jax.jit(models["style_encoder"].init)(ke, x, y)["params"],
    )
    return DeIdBundle(cfg=cfg, models=models, fan=fan, params=params)


def jax_fan_params(seed: int = 0):
    """The ``fan_priv`` parameters ``jax_bundle(seed=seed)`` holds."""
    kf = jax.random.split(jax.random.key(seed), 5)[1]
    return jax.jit(FAN().init)(kf, jnp.zeros((1, 64, 64, 3)))["params"]


def with_dtype(bundle: DeIdBundle, compute_dtype: str) -> DeIdBundle:
    """The same parameters under modules of another compute dtype."""
    cfg = jax_cfg(compute_dtype)
    dtype = jnp.dtype(compute_dtype)
    m = cfg.model
    models = build_gan_models(
        img_size=m.img_size, style_dim=m.style_dim, latent_dim=m.latent_dim,
        num_domains=m.num_domains, w_hpf=m.w_hpf, max_conv_dim=m.max_conv_dim, dtype=dtype,
    )
    return DeIdBundle(cfg=cfg, models=models, fan=FAN(dtype=dtype), params=bundle.params)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def torch_bundle(jb: DeIdBundle, compute_dtype: str = "bfloat16"):
    """A CPU port bundle carrying ``jb``'s parameters."""
    from ppvision_tpu_torch.deid import build_deid
    from ppvision_tpu_torch.utils.jax_params import load_deid_params

    tb = build_deid(0, torch_cfg(compute_dtype), device="cpu")
    load_deid_params(tb, numpy_tree(jb.params))
    return tb


def diff_stats(a: np.ndarray, b: np.ndarray) -> tuple[float, float]:
    """(p99, max) of |a - b|."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(np.quantile(d, 0.99)), float(d.max())


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op torch threads for a test module's small nets (import it
    into the module to use it): the parallel test workers share the
    host's cores, and more threads a worker only spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def stand_in_kernels(events):
    """A CPU profile's events, each given its self CPU time as one kernel:
    the CPU's stand-in for the kernels a profile on the card attaches to
    the ops that launch them (``chip_smoke.device_ms_by_span``)."""
    from torch.autograd.profiler_util import Kernel

    for e in events:
        e.kernels = [Kernel("k", 0, e.self_cpu_time_total)] if e.self_cpu_time_total > 0 else []
    return events
