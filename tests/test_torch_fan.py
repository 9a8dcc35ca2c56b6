"""Port FAN (models/fan.py) against the JAX package's FAN with the same
parameters: the privacy heatmaps of ``get_heatmap(privacy=True)``, the
preprocess pipeline, and the folded head in bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppvision_tpu.models import fan as jfan
from ppvision_tpu.ops.image import resize_bilinear as jax_resize
from ppvision_tpu_torch.models import fan as tfan
from ppvision_tpu_torch.ops.image import resize_bilinear
from ppvision_tpu_torch.utils.jax_params import fan_state_dict

from .torch_parity import diff_stats, jax_fan_params, numpy_tree

S = 64  # FAN input size (fan_input_size of the tiny config)


@pytest.fixture(scope="module")
def setup():
    params = jax_fan_params()
    x = np.random.default_rng(0).random((2, 48, 48, 3)).astype(np.float32)
    return params, x


def _port(params, dtype):
    fan = tfan.FAN(dtype=getattr(torch, dtype))
    fan.load_state_dict(fan_state_dict(numpy_tree(params)))
    return fan.eval()


def test_privacy_heatmaps_match_jax_f32(setup):
    params, x = setup
    want = jfan.get_heatmap(jfan.FAN(dtype=jnp.float32), params, jnp.asarray(x), privacy=True, input_size=S)
    with torch.no_grad():
        got = tfan.get_heatmap(_port(params, "float32"), torch.from_numpy(x), privacy=True, input_size=S)
    for g, w in zip(got, want):
        assert g.shape == (2, S, S, 1)
        # f32 conv sums in another order through ~60 conv layers; the
        # masks are clamped sums of head channels that reach ~50.
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-4)


def test_preprocess_heatmaps_match_jax():
    hm = np.random.default_rng(1).random((2, 256, 256, 98)).astype(np.float32) * 0.3
    want = jfan.preprocess_heatmaps(jnp.asarray(hm))
    got = tfan.preprocess_heatmaps(torch.from_numpy(hm))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_full_head_heatmaps_match_jax_f32(setup):
    params, x = setup
    want = jfan.get_heatmap(jfan.FAN(dtype=jnp.float32), params, jnp.asarray(x), input_size=S)
    with torch.no_grad():
        got = tfan.get_heatmap(_port(params, "float32"), torch.from_numpy(x), input_size=S)
    for g, w in zip(got, want):
        # The preprocess pipeline raises head channels to powers up to 4
        # before summing, which multiplies the f32 head error by as much.
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-3)


def test_folded_head_bf16_within_bf16_noise(setup):
    """bf16 rounds at the same ops on both sides (checked elementwise),
    but a 1-ulp change in one conv sum travels through the random-weight
    hourglass as far as bf16 itself departs from f32.  So the port's bf16
    head must sit no further from JAX's bf16 head than JAX's bf16 head
    sits from its f32 head."""
    params, x = setup
    heads = {}
    for dtype in ("float32", "bfloat16"):
        d = jnp.dtype(dtype)
        jf = jfan.FAN(dtype=d, fold_privacy_head=True)
        xr = jax_resize(jnp.asarray(x).astype(d), (S, S)) * 0.5 + 0.5
        heads["jax", dtype] = np.asarray(jax.jit(lambda p: jf.apply({"params": p}, xr))(params))
    with torch.no_grad():
        xt = resize_bilinear(torch.from_numpy(x).bfloat16().permute(0, 3, 1, 2), (S, S)) * 0.5 + 0.5
        heads["port"] = _port(params, "bfloat16")(xt, fold_privacy_head=True).permute(0, 2, 3, 1).numpy()
    p99, mx = diff_stats(heads["port"], heads["jax", "bfloat16"])
    n99, nmx = diff_stats(heads["jax", "bfloat16"], heads["jax", "float32"])
    assert p99 <= 1.5 * n99 and mx <= 1.5 * nmx, (p99, mx, n99, nmx)


def test_reference_key_names():
    keys = set(tfan.FAN().state_dict())
    for k in ("conv1.conv.weight", "bn1.running_var", "conv2.downsample.0.weight",
              "conv2.downsample.2.weight", "m0.coordconv.conv.weight", "m0.b1_4.conv1.weight",
              "m0.b2_plus_1.bn3.bias", "m0.b3_1.conv3.weight", "top_m_0.bn1.running_mean",
              "conv_last0.bias", "bn_end0.weight", "l0.weight"):
        assert k in keys, k
    assert tfan.FAN().state_dict()["m0.coordconv.conv.weight"].shape == (256, 259, 1, 1)
