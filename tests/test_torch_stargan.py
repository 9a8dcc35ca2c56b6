"""Port StarGAN-v2 nets (models/stargan.py) against the JAX package with
the same parameters: Generator.encode / decode, StyleEncoder and
MappingNetwork, in f32 and bf16 compute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppvision_tpu.models.stargan import Generator as JGenerator
from ppvision_tpu_torch.utils import jax_params

from .torch_parity import TINY, diff_stats, jax_bundle, numpy_tree, with_dtype

B = 3


@pytest.fixture(scope="module")
def setup():
    jb = jax_bundle("float32", with_fan=False)
    rng = np.random.default_rng(0)
    n = TINY["img_size"]
    data = dict(
        x=rng.random((B, n, n, 3)).astype(np.float32) * 2 - 1,
        masks=tuple(rng.random((B, 256, 256, 1)).astype(np.float32) for _ in range(2)),
        s=rng.standard_normal((B, TINY["style_dim"])).astype(np.float32),
        z=rng.standard_normal((B, TINY["latent_dim"])).astype(np.float32),
        y=np.array([0, 1, 1], np.int32),
    )
    return jb, data


def _jax_gan(jb, dtype, data):
    b = with_dtype(jb, dtype)
    gen, p = b.models["generator"], b.params.generator
    masks = tuple(jnp.asarray(m) for m in data["masks"])

    def run(p):
        z, hps = gen.apply({"params": p}, jnp.asarray(data["x"]), masks, method=JGenerator.encode)
        out = gen.apply({"params": p}, z, jnp.asarray(data["s"]), hps, method=JGenerator.decode)
        return z, dict(hps), out

    z, hps, out = jax.jit(run)(p)
    sty = b.models["style_encoder"].apply({"params": b.params.style_encoder},
                                          jnp.asarray(data["x"]), jnp.asarray(data["y"]))
    mp = b.models["mapping_network"].apply({"params": b.params.mapping_network},
                                           jnp.asarray(data["z"]), jnp.asarray(data["y"]))
    return dict(z=np.asarray(z.astype(jnp.float32)),
                hps={s: np.asarray(h.astype(jnp.float32)) for s, h in hps.items()},
                out=np.asarray(out), style=np.asarray(sty), mapped=np.asarray(mp))


def _port_gan(jb, dtype, data):
    from ppvision_tpu_torch.models.stargan import build_gan_models

    m = build_gan_models(img_size=TINY["img_size"], style_dim=TINY["style_dim"],
                         latent_dim=TINY["latent_dim"], max_conv_dim=TINY["max_conv_dim"],
                         dtype=getattr(torch, dtype))
    p = numpy_tree(jb.params)
    m["generator"].load_state_dict(jax_params.generator_state_dict(p.generator))
    m["style_encoder"].load_state_dict(jax_params.style_encoder_state_dict(p.style_encoder))
    m["mapping_network"].load_state_dict(jax_params.mapping_state_dict(p.mapping_network))
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    y = torch.from_numpy(data["y"]).long()
    with torch.no_grad():
        gen = m["generator"]
        z, hps = gen.encode(nchw(data["x"]), tuple(nchw(k) for k in data["masks"]))
        out = gen.decode(z, torch.from_numpy(data["s"]), hps)
        sty = m["style_encoder"](nchw(data["x"]), y)
        mp = m["mapping_network"](torch.from_numpy(data["z"]), y)
    nhwc = lambda t: t.permute(0, 2, 3, 1).float().numpy()  # noqa: E731
    return dict(z=nhwc(z), hps={s: nhwc(h) for s, h in hps}, out=nhwc(out),
                style=sty.numpy(), mapped=mp.numpy())


def test_generator_and_style_nets_match_jax_f32(setup):
    jb, data = setup
    want = _jax_gan(jb, "float32", data)
    got = _port_gan(jb, "float32", data)
    assert sorted(got["hps"]) == sorted(want["hps"]) == [32, 64]
    # f32 throughout; sums reordered over ~30 conv layers: relative to
    # each tensor's scale.
    for k in ("z", "out", "style", "mapped"):
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-5 * scale, err_msg=k)
    for s in want["hps"]:
        scale = np.abs(want["hps"][s]).max()
        np.testing.assert_allclose(got["hps"][s], want["hps"][s], rtol=0, atol=2e-5 * scale)


def test_generator_and_style_nets_bf16_within_bf16_noise(setup):
    """Same criterion as the FAN's: the port's bf16 result must sit no
    further from JAX's bf16 result than that sits from JAX's f32 one."""
    jb, data = setup
    j32 = _jax_gan(jb, "float32", data)
    j16 = _jax_gan(jb, "bfloat16", data)
    got = _port_gan(jb, "bfloat16", data)
    for k in ("z", "out", "style", "mapped"):
        p99, mx = diff_stats(got[k], j16[k])
        n99, nmx = diff_stats(j16[k], j32[k])
        assert p99 <= 1.5 * n99 and mx <= 1.5 * nmx, (k, p99, mx, n99, nmx)


def test_reference_key_names():
    from ppvision_tpu_torch.models.stargan import build_gan_models

    m = build_gan_models(img_size=64, style_dim=16, latent_dim=8, max_conv_dim=64)
    g = set(m["generator"].state_dict())
    for k in ("from_rgb.weight", "encode.0.conv1x1.weight", "encode.0.norm1.weight",
              "encode.4.conv2.bias", "decode.0.norm1.fc.weight", "decode.4.conv1.weight",
              "to_rgb.0.weight", "to_rgb.2.bias"):
        assert k in g, k
    assert "shared.6.weight" in m["style_encoder"].state_dict()
    assert "unshared.1.6.bias" in m["mapping_network"].state_dict()
    # The int8 decode is a compute variant over the same state_dict
    # (tests/test_quant.py::test_quant_decode_param_tree_identical).
    q = build_gan_models(img_size=64, style_dim=16, latent_dim=8, max_conv_dim=64, quant_decode=True)
    assert {k: v.shape for k, v in q["generator"].state_dict().items()} == {
        k: v.shape for k, v in m["generator"].state_dict().items()
    }
