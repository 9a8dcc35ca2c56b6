"""The port's face-ID metric (metrics/face_id.py) against the JAX
package's: IResNet on weights carried from the port's state_dict through
``arcface_variables_from_torch`` (which also holds the ``fc``
permutation, NCHW flatten against NHWC), the whole-frame embed with its
antialiased shrink, the 5-point similarity, the template warp and the
FAN-aligned embed, all in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppvision_tpu.metrics import face_id as jf
from ppvision_tpu.models.fan import FAN as JFAN
from ppvision_tpu_torch.metrics import face_id as tf
from ppvision_tpu_torch.models.fan import FAN
from ppvision_tpu_torch.utils.jax_params import fan_state_dict

from .test_torch_fid import randomize_
from .torch_parity import jax_fan_params, numpy_tree

LAYERS = (1, 1, 1, 1)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this file's nets: the parallel test
    workers share the host's cores, and more threads a worker only spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    port = tf.IResNet(layers=LAYERS)
    randomize_(port, 3)
    with torch.no_grad():
        for name, t in port.state_dict().items():
            if name.endswith("prelu.weight"):
                t.uniform_(0.0, 0.5, generator=torch.Generator().manual_seed(4))
    params = jf.arcface_variables_from_torch({k: v.numpy() for k, v in port.state_dict().items()}, layers=LAYERS)
    return port, jf.IResNet(layers=LAYERS), params


def _faces(seed: int, size: int, b: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).random((b, size, size, 3), dtype=np.float32)


def test_iresnet_matches_jax(nets):
    port, jnet, params = nets
    x = _faces(0, 112) * 2 - 1
    want = np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    scale = float(np.abs(want).max())
    assert got.shape == want.shape == (2, 512)
    # f32 conv and GEMM sums in another order; measured ~1e-6 of the scale.
    assert np.abs(got - want).max() <= 1e-4 * scale, (np.abs(got - want).max(), scale)


@pytest.mark.parametrize("size", [256, 64])
def test_embed_matches_jax_resize(nets, size):
    """256 -> 112 shrinks with ``jax.image.resize``'s antialiased bilinear,
    64 -> 112 grows without it; ``F.interpolate(antialias=True)`` gives
    both."""
    port, jnet, params = nets
    x = _faces(1, size)
    want = np.asarray(jax.jit(jf.make_embed_fn(jnet, params))(jnp.asarray(x)))
    got = tf.make_embed_fn(port)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-6)
    assert np.abs(got - want).max() <= 1e-4, np.abs(got - want).max()
    resized = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(112, 112),
                                              mode="bilinear", antialias=True).permute(0, 2, 3, 1).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 112, 112, 3), "bilinear"))
    assert np.abs(resized - want).max() <= 1e-5, np.abs(resized - want).max()
    a, b = torch.from_numpy(x), torch.from_numpy(_faces(2, size))
    fn = tf.make_embed_fn(port)
    got = float(tf.face_id_cosine(fn, a, b))
    want = float(jf.face_id_cosine(jf.make_embed_fn(jnet, params), jnp.asarray(x), jnp.asarray(_faces(2, size))))
    assert abs(got - want) <= 1e-4 and abs(float(tf.face_id_cosine(fn, a, a)) - 1.0) <= 1e-6


def test_similarity_points_and_warp_match_jax():
    rng = np.random.default_rng(5)
    lm = rng.uniform(40, 200, (2, 98, 2)).astype(np.float32)
    pts = np.asarray(jf.fan_five_points(jnp.asarray(lm)))
    # The eye means sum 9 points in another order: 1 ulp.
    np.testing.assert_allclose(tf.fan_five_points(torch.from_numpy(lm)).numpy(), pts, rtol=1e-6)
    dst = jf.ARCFACE_TEMPLATE[None].repeat(2, 0)
    mat_j, t_j = (np.asarray(v) for v in jf.similarity_from_points(jnp.asarray(pts), jnp.asarray(dst)))
    mat, t = (v.numpy() for v in tf.similarity_from_points(torch.from_numpy(pts), torch.from_numpy(dst)))
    np.testing.assert_allclose(mat, mat_j, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t, t_j, rtol=1e-5, atol=1e-4)
    img = _faces(6, 256)
    want = np.asarray(jf.warp_to_template(jnp.asarray(img), jnp.asarray(pts)))
    got = tf.warp_to_template(torch.from_numpy(img), torch.from_numpy(pts)).numpy()
    assert got.shape == want.shape == (2, 112, 112, 3)
    # The f32 sample coordinates differ by ~1e-5 px (the solve's sums in
    # another order); on pixel noise that moves a value ~1e-4 (measured
    # 1.2e-4).
    assert np.abs(got - want).max() <= 1e-3, np.abs(got - want).max()


def test_aligned_embed_matches_jax(nets):
    """FAN landmarks at a 64^2 working size (the eval's test config) on a
    carried-over FAN, then the warp and the embed.  The faces carry a
    smooth blob so each heatmap's peak is clear of ties."""
    port, jnet, params = nets
    fan_params = jax_fan_params(2)
    fan = FAN()
    fan.load_state_dict(fan_state_dict(numpy_tree(fan_params)))
    yy, xx = np.mgrid[0:64, 0:64]
    blob = np.exp(-((yy - 30.0) ** 2 + (xx - 34.0) ** 2) / (2 * 12.0**2))[None, ..., None]
    x = (0.7 * blob + 0.2 * _faces(7, 64)).astype(np.float32)
    want = np.asarray(jax.jit(jf.make_aligned_embed_fn(jnet, params, JFAN(), fan_params, input_size=64))(jnp.asarray(x)))
    got = tf.make_aligned_embed_fn(port, fan.eval(), input_size=64)(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-4, np.abs(got - want).max()
