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


# ---------------------------------------------------------------------------
# The norm apply (ops/instats.py::norm_apply): the composite that the CPU,
# f32/f64 and every autograd call run, held to the formulas the modules
# computed before the norms and their leaky ReLUs became one call.
# ---------------------------------------------------------------------------


def _old_instance_norm(norm, x):
    """``InstanceNorm.forward`` as it was, frozen here (``norm`` None:
    the AdaIN's, without affine)."""
    from ppvision_tpu_torch.models.stargan import _moments_nchw

    mean, m2 = _moments_nchw(x)
    mean, m2 = mean[:, :, None, None], m2[:, :, None, None]
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    var = torch.clamp_min(m2 - mean * mean, 0.0)
    y = (xf - mean) * torch.rsqrt(var + 1e-5)
    if norm is not None:
        y = y * norm.weight[:, None, None] + norm.bias[:, None, None]
    return y.to(x.dtype)


def _old_adain(adain, x, s):
    """``AdaIN.forward`` as it was."""
    from ppvision_tpu_torch.models.stargan import _dense

    gamma, beta = torch.chunk(_dense(s, adain.fc, adain.compute_dtype), 2, dim=1)
    y = _old_instance_norm(None, x)
    return ((1 + gamma[:, :, None, None]) * y + beta[:, :, None, None]).to(x.dtype)


def _old_resblk(blk, x):
    """``ResBlk.forward`` as it was: the norm, then ``leaky_relu``."""
    from ppvision_tpu_torch.models import stargan as sg

    s = sg.avg_pool_2x(x) if blk.downsample else x
    if blk.learned_sc:
        s = blk.conv1x1(s)
    r = sg.leaky_relu(_old_instance_norm(blk.norm1, x) if blk.normalize else x)
    r = sg._resample_conv(r, blk.conv1, "down") if blk.downsample else blk.conv1(r)
    r = sg.leaky_relu(_old_instance_norm(blk.norm2, r) if blk.normalize else r)
    return sg._res_scale(s, blk.conv2(r))


def _old_adain_resblk(blk, x, s):
    """``AdainResBlk.forward`` as it was (exact convs)."""
    from ppvision_tpu_torch.models import stargan as sg

    r = sg.leaky_relu(_old_adain(blk.norm1, x, s))
    r = sg._resample_conv(r, blk.conv1, "up") if blk.upsample else blk.conv1(r)
    r = blk.conv2(sg.leaky_relu(_old_adain(blk.norm2, r, s)))
    if blk.w_hpf == 0:
        sc = blk.conv1x1(x) if blk.learned_sc else x
        r = sg._res_scale(r, sg.upsample_nearest_2x(sc) if blk.upsample else sc)
    return r


def _old_to_rgb(gen, x):
    """``Generator.decode``'s last lines as they were."""
    from ppvision_tpu_torch.models import stargan as sg

    norm, _, conv = gen.to_rgb
    x = sg.leaky_relu(_old_instance_norm(norm, x))
    y = torch.nn.functional.conv2d(x, conv.weight.to(x.dtype)) + conv.bias.to(x.dtype)[:, None, None]
    return y.to(torch.promote_types(y.dtype, torch.float32))


def _norm_input(dtype, b=2, c=16, h=8, seed=0, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, c, h, h), generator=g) * 3 + 1
    x[:, 0] = 2.5  # a constant channel: variance 0, so the clamp and eps decide
    return (x * scale).to(dtype).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("scale", [3e-3, 1.0, 3e4])
@pytest.mark.parametrize("variant", ["affine", "adain"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_norm_apply_composite_equals_the_old_formulas(dtype, variant, scale):
    """``InstanceNorm`` and ``AdaIN`` (each now with its leaky ReLU) and
    the composite give the bytes of the old norm, then ``leaky_relu``,
    at small, unit and large magnitudes."""
    from ppvision_tpu_torch.models.stargan import AdaIN, InstanceNorm, leaky_relu
    from ppvision_tpu_torch.ops.instats import instance_moments, norm_apply_ref

    dt = getattr(torch, dtype)
    x = _norm_input(dt, scale=scale)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        if variant == "adain":
            mod = AdaIN(8, 16, dtype=dt)
            mod.fc.weight.copy_(torch.randn(mod.fc.weight.shape, generator=g) * 0.3)
            mod.fc.bias.copy_(torch.randn(mod.fc.bias.shape, generator=g) * 0.3)
            s = torch.randn((2, 8), generator=g).to(dt)
            want, got = _old_adain(mod, x, s), mod(x, s)
            h = torch.nn.functional.linear(s, mod.fc.weight.to(dt)) + mod.fc.bias.to(dt)
            kw = dict(style=h)
        else:
            mod = InstanceNorm(16)
            mod.weight.copy_(1 + 0.5 * torch.randn(16, generator=g))
            mod.bias.copy_(0.5 * torch.randn(16, generator=g))
            want, got = _old_instance_norm(mod, x), mod(x)
            kw = dict(weight=mod.weight, bias=mod.bias)
        want = leaky_relu(want)
        m, m2 = instance_moments(x.permute(0, 2, 3, 1))
        plain = norm_apply_ref(x, m, m2, 1e-5, float(torch.tensor(0.2, dtype=dt)), **kw)
    assert got.dtype == want.dtype == dt
    assert torch.equal(_bits(got), _bits(want)) and torch.equal(_bits(plain), _bits(want))


def _bits(t):
    """The tensor's bytes as integers: signed zeros and NaNs compared too."""
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


def _old_decode(gen, z, s, hps=()):
    """``Generator.decode`` as it was."""
    x = z if gen.compute_dtype is None else z.to(gen.compute_dtype)
    if gen.compute_dtype is not None:
        s = s.to(gen.compute_dtype)
    hp_by_size = dict(hps)
    for blk in gen._modules["decode"]:
        x = blk(x, s)
        hp = hp_by_size.get(x.shape[-2]) if blk.upsample else None
        if hp is not None:
            if x.shape[0] != hp.shape[0]:
                hp = hp.repeat(x.shape[0] // hp.shape[0], 1, 1, 1)
            x = x + hp
    return _old_to_rgb(gen, x)


def _generator_grads(gen, x, s, masks):
    gen.zero_grad()
    xs = x.clone().requires_grad_(True)
    z, hps = gen.encode(xs, masks)
    out = gen.decode(z, s, hps)
    cot = torch.linspace(-1, 1, out.numel()).reshape(out.shape)
    (out.float() * cot).sum().backward()
    return [out.detach(), xs.grad] + [p.grad.clone() for p in gen.parameters()]


def test_generator_grads_on_the_cpu_are_unchanged(monkeypatch):
    """The autograd path runs the composite: the Generator's output and
    every gradient (the image's and each parameter's, the norms' affine
    included) equal those of the frozen forwards bit for bit (f32, the
    tiny widths, B = 1, the high-pass skips on)."""
    from ppvision_tpu_torch.models import stargan as sg

    gen = sg.init_params_(sg.Generator(img_size=TINY["img_size"], style_dim=TINY["style_dim"],
                                       max_conv_dim=TINY["max_conv_dim"], w_hpf=1.0), seed=3)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in gen.modules():
            if isinstance(m, sg.InstanceNorm):
                m.weight.copy_(1 + 0.3 * torch.randn(m.weight.shape, generator=g))
                m.bias.copy_(0.3 * torch.randn(m.bias.shape, generator=g))
    x = torch.rand((1, 3, 64, 64), generator=g).contiguous(memory_format=torch.channels_last) * 2 - 1
    s = torch.randn((1, TINY["style_dim"]), generator=g)
    masks = tuple(torch.rand((1, 1, 256, 256), generator=g) for _ in range(2))
    new = _generator_grads(gen, x, s, masks)
    monkeypatch.setattr(sg.ResBlk, "forward", _old_resblk)
    monkeypatch.setattr(sg.AdainResBlk, "forward", _old_adain_resblk)
    monkeypatch.setattr(sg.Generator, "decode", _old_decode)
    old = _generator_grads(gen, x, s, masks)
    assert len(new) == len(old) > 2
    for a, b in zip(new, old):
        assert torch.equal(a, b)


def test_norm_apply_dispatch_sends_what_the_kernel_does_not_take_to_the_composite():
    """CPU tensors always run the composite and count nothing; the
    kernel's rule refuses f32, a C whose pixels are not whole 16-byte
    loads, an f32 style and any call that needs a gradient, and takes
    bf16 under no_grad even where the parameters are trainable."""
    from ppvision_tpu_torch.ops import instats

    x = _norm_input(torch.bfloat16, c=16)
    m, m2 = instats.instance_moments(x.permute(0, 2, 3, 1))
    w = torch.ones(16, requires_grad=True)
    b = torch.zeros(16, requires_grad=True)
    style = torch.zeros((2, 32), dtype=torch.bfloat16)
    before = (instats.norm_apply.launches, instats.norm_apply.eager)
    with torch.no_grad():
        got = instats.norm_apply(x, m, m2, 1e-5, 0.2001953125, w, b)
        assert torch.equal(got, instats.norm_apply_ref(x, m, m2, 1e-5, 0.2001953125, w, b))
        assert instats.norm_apply_takes(x, w, b)
        assert instats.norm_apply_takes(x, style=style)
        assert not instats.norm_apply_takes(x.float(), w, b)
        assert not instats.norm_apply_takes(x, style=style.float())
        assert not instats.norm_apply_takes(_norm_input(torch.bfloat16, c=12))
    assert (instats.norm_apply.launches, instats.norm_apply.eager) == before
    assert not instats.norm_apply_takes(x, w, b)  # grad enabled, trainable weight
    assert instats.norm_apply_takes(x)
    assert not instats.norm_apply_takes(x.clone().requires_grad_(True))
    assert not instats.norm_apply_takes(x, style=style.clone().requires_grad_(True))
