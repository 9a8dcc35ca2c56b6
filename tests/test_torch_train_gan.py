"""The port's GAN trainer (train/gan.py) against the JAX package's.

Two train steps of the whole iteration (D, D, G, G with R1, LPIPS, a
RAFT flow loss and the heatmap L1, then the EMA) run on both packages at
f64 from the same parameters and batches, at the tiny config of
``tests/test_train_gan.py``.  f64 takes the frameworks' noise floor to
~1e-15, so the losses are held to the JAX package's own free-running f64
golden tolerances (``test_train_free_running_f64.METRIC_REL_TOL``) and
the parameters after two Adam steps to 1e-6.  The batches carry the
private images (``x_priv``) because the JAX camera computes in f32 at
any precision.  Also here: one f32 step of the port, a bit-exact resume,
the Discriminator against the JAX package's, and ``gradcheck`` of the
four kernel Functions through their plain forwards.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppvision_tpu_torch.utils import jax_params

from .test_train_free_running_f64 import METRIC_REL_TOL
from .torch_parity import numpy_tree

IMG = 32
FAN_IN = 64
B = 2
TINY = dict(img_size=IMG, fan_input_size=FAN_IN, max_conv_dim=32, style_dim=8)
TERMS = 16
RAFT_CFG = dict(iters=1, corr_levels=2, corr_radius=2)
PARAM_ABS_TOL = 1e-6


@contextlib.contextmanager
def _x64():
    """JAX x64 on for the block, restored after (as the f64 golden does)."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _batches(n: int, latent_dim: int, dtype=np.float64) -> list[dict]:
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        out.append(dict(
            x_src=rng.random((B, IMG, IMG, 3)).astype(dtype),
            x_ref=rng.random((B, IMG, IMG, 3)).astype(dtype),
            x_ref2=rng.random((B, IMG, IMG, 3)).astype(dtype),
            y_src=np.zeros(B, np.int32),
            y_ref=np.ones(B, np.int32),
            z_trg=rng.standard_normal((B, latent_dim)).astype(dtype),
            z_trg2=rng.standard_normal((B, latent_dim)).astype(dtype),
        ))
    return out


def _f64_grid(grid_fn):
    """The JAX RAFT's coordinate grid in f64: its f32 grid meets an f64
    carry in the refinement scan under x64.  The grid holds integers, so
    its values are the same in either dtype (the port's grid takes the
    features' dtype)."""

    def coords_grid(*args, **kw):
        return grid_fn(*args, **kw).astype(jnp.float64)

    return coords_grid


@pytest.fixture(scope="module")
def jax_run():
    """Two JAX train steps at f64 (built and compiled once), with the
    parameters they start from and end at, as numpy."""
    from ppvision_tpu.models import raft as jax_raft

    with _x64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_raft, "coords_grid", _f64_grid(jax_raft.coords_grid))
        from ppvision_tpu.config import CameraConfig, FaceDeIdConfig, ModelConfig
        from ppvision_tpu.metrics.lpips import LPIPS
        from ppvision_tpu.models.fan import FAN
        from ppvision_tpu.models.stargan import build_gan_models
        from ppvision_tpu.optics.camera import CameraSpec, camera_apply, init_camera_params, make_camera_constants
        from ppvision_tpu.train.aux_losses import build_flow_fn, build_lpips_fn
        from ppvision_tpu.train.gan import (
            EMA_NETS, GAN_NETS, FrozenNets, GANTrainState, make_optimizers, make_train_step,
        )

        cfg = FaceDeIdConfig(
            model=ModelConfig(**TINY, compute_dtype="float64"), camera=CameraConfig(n=IMG, zernike_terms=TERMS)
        )
        # init_gan's modules, keys and init inputs, with the inits jitted;
        # the params at f64 and optimizer states made from them, as the
        # f64 golden does.
        m = cfg.model
        models = build_gan_models(img_size=IMG, style_dim=m.style_dim, latent_dim=m.latent_dim,
                                  max_conv_dim=m.max_conv_dim, dtype=jnp.float64)
        fan = FAN(dtype=jnp.float64)
        kg, km, ke, kd = jax.random.split(jax.random.key(0), 4)
        x, y = jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1,), jnp.int32)
        s, z = jnp.zeros((1, m.style_dim)), jnp.zeros((1, m.latent_dim))
        masks = (jnp.zeros((1, 256, 256, 1)), jnp.zeros((1, 256, 256, 1)))
        params = {
            "generator": jax.jit(models["generator"].init)(kg, x, s, masks)["params"],
            "mapping_network": jax.jit(models["mapping_network"].init)(km, z, y)["params"],
            "style_encoder": jax.jit(models["style_encoder"].init)(ke, x, y)["params"],
            "discriminator": jax.jit(models["discriminator"].init)(kd, x, y)["params"],
        }
        params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), params)
        optims = make_optimizers(cfg)
        state = GANTrainState(
            params=params,
            opt_states={k: optims[k].init(params[k]) for k in GAN_NETS},
            ema_params={k: jax.tree_util.tree_map(jnp.copy, params[k]) for k in EMA_NETS},
            step=jnp.zeros((), jnp.int32),
        )
        spec = CameraSpec(n=IMG, zernike_terms=TERMS)
        fan_params = jax.jit(fan.init)(jax.random.key(1), jnp.zeros((1, FAN_IN, FAN_IN, 3)))["params"]
        frozen = FrozenNets(
            camera_params=init_camera_params(jax.random.key(2), spec),
            camera_consts=make_camera_constants(spec),
            fan_params=fan_params,
            fan_priv_params=fan_params,
        )
        x0 = jnp.zeros((1, IMG, IMG, 3))
        lpips_params = jax.jit(LPIPS().init)(jax.random.key(7), x0, x0)["params"]
        lpips_fn, _ = build_lpips_fn(IMG, params=lpips_params)
        raft = jax_raft.RAFT(**RAFT_CFG)
        raft_params = jax.jit(functools.partial(raft.init, iters=1))(jax.random.key(8), x0, x0)["params"]
        flow_fn, _ = build_flow_fn(params=raft_params, **RAFT_CFG)
        batches = _batches(2, cfg.model.latent_dim)
        for bt in batches:
            sensor, _ = camera_apply(frozen.camera_params, frozen.camera_consts, jnp.asarray(bt["x_src"], jnp.float32))
            bt["x_priv"] = np.asarray(sensor, np.float64)
        step = make_train_step(models, fan, cfg, lpips_fn=lpips_fn, flow_fn=flow_fn)
        metrics = []
        start = numpy_tree(state.params)
        for bt in batches:
            state, m = step(state, frozen, bt)
            metrics.append({k: float(v) for k, v in m.items()})
        return dict(
            start=start, end=numpy_tree(state.params), ema=numpy_tree(state.ema_params), metrics=metrics,
            fan=numpy_tree(fan_params), lpips=numpy_tree(lpips_params), raft=numpy_tree(raft_params),
            batches=batches,
        )


def _port_cfg(compute_dtype: str, **loss):
    from ppvision_tpu_torch.config import CameraConfig, FaceDeIdConfig, LossConfig, ModelConfig

    return FaceDeIdConfig(
        model=ModelConfig(**TINY, compute_dtype=compute_dtype),
        camera=CameraConfig(n=IMG, zernike_terms=TERMS),
        loss=LossConfig(**loss),
    )


def _port_trainer(jr, compute_dtype: str, **loss):
    """The port's state, frozen nets and train step on the JAX run's
    parameters, on the CPU."""
    from ppvision_tpu_torch.models.fan import FAN
    from ppvision_tpu_torch.optics.camera import Camera, CameraSpec, make_camera_constants
    from ppvision_tpu_torch.train.aux_losses import build_flow_fn, build_lpips_fn
    from ppvision_tpu_torch.train.gan import FrozenNets, init_gan, make_train_step

    cfg = _port_cfg(compute_dtype, **loss)
    dtype = getattr(torch, compute_dtype)
    wdtype = torch.promote_types(dtype, torch.float32)
    state = init_gan(0, cfg, device="cpu")
    jax_params.load_train_params(state, jr["start"])
    # Each module takes the working dtype before its weights: the JAX
    # package's inits draw f64 values under x64.
    fan = FAN(dtype=dtype).to(wdtype)
    fan.load_state_dict(jax_params.fan_state_dict(jr["fan"]))
    fan = fan.eval().requires_grad_(False)
    spec = CameraSpec(n=IMG, zernike_terms=TERMS)
    frozen = FrozenNets(camera=Camera(spec).requires_grad_(False), camera_consts=make_camera_constants(spec),
                        fan=fan, fan_priv=fan)
    lpips_fn, lpips = build_lpips_fn(device="cpu")
    lpips.to(wdtype).load_state_dict(jax_params.lpips_state_dict(jr["lpips"]))
    flow_fn, raft = build_flow_fn(device="cpu", **RAFT_CFG)
    raft.to(wdtype).load_state_dict(jax_params.raft_state_dict(jr["raft"]))
    return state, frozen, make_train_step(cfg, lpips_fn, flow_fn)


def _state_dicts(state):
    return ({k: m.state_dict() for k, m in state.nets.items()}, {k: m.state_dict() for k, m in state.ema.items()})


_BRIDGE = {
    "generator": jax_params.generator_state_dict,
    "mapping_network": jax_params.mapping_state_dict,
    "style_encoder": jax_params.style_encoder_state_dict,
    "discriminator": jax_params.discriminator_state_dict,
}


def test_two_train_steps_match_jax_at_f64(jax_run):
    state, frozen, step = _port_trainer(jax_run, "float64")
    for it, bt in enumerate(jax_run["batches"]):
        got = {k: float(v) for k, v in step(state, frozen, bt).items()}
        want = jax_run["metrics"][it]
        assert set(got) == set(want)
        for k, w in want.items():
            err = abs(got[k] - w) / max(abs(w), 1e-3)
            assert err < METRIC_REL_TOL[it], (it, k, got[k], w, err)
    assert state.step == 2
    nets, ema = _state_dicts(state)
    for name, fn in _BRIDGE.items():
        trees = [(nets[name], jax_run["end"][name])]
        if name in ema:
            trees.append((ema[name], jax_run["ema"][name]))
        for port_sd, tree in trees:
            for key, want in fn(tree).items():
                d = float((port_sd[key].double() - want.double()).abs().max())
                assert d <= PARAM_ABS_TOL, (name, key, d)


def test_one_train_step_f32(jax_run):
    """Mirrors test_train_gan.py::test_one_train_step on the port."""
    state, frozen, step = _port_trainer(jax_run, "float32")
    before, before_ema = _state_dicts(state)
    before = {k: {n: t.clone() for n, t in sd.items()} for k, sd in before.items()}
    before_ema = {k: {n: t.clone() for n, t in sd.items()} for k, sd in before_ema.items()}
    batch = {k: v.astype(np.float32) if v.dtype == np.float64 else v
             for k, v in jax_run["batches"][0].items() if k != "x_priv"}
    metrics = step(state, frozen, batch)
    assert state.step == 1
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k
    for key in ("D/latent_real", "D/latent_reg", "G/latent_adv", "G/ref_cyc", "G/ref_lpips", "G/latent_flow"):
        assert key in metrics
    after, after_ema = _state_dicts(state)

    def delta(a, b):
        return max(float((a[n] - b[n]).abs().max()) for n in a)

    for net in before:
        assert delta(after[net], before[net]) > 0, net
    for net in before_ema:
        d_ema, d_par = delta(after_ema[net], before_ema[net]), delta(after[net], before[net])
        assert 0 < d_ema < d_par, net
    assert float(metrics["D/latent_reg"]) > 0
    for net in state.nets.values():
        assert all(p.grad is None for p in net.parameters())


def test_resume_is_bit_exact(jax_run, tmp_path):
    """Two steps straight equal one step, save, restore into a fresh
    state, one more step (the reference resume, solver.py:92-134)."""
    from ppvision_tpu_torch.utils.checkpoint import StepCheckpoints, restore_train_state, save_train_state

    batch = {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in jax_run["batches"][0].items()}
    state, frozen, step = _port_trainer(jax_run, "float32")
    step(state, frozen, batch)
    ckpts = StepCheckpoints(str(tmp_path / "ck"))
    save_train_state(ckpts, state)
    step(state, frozen, batch)

    resumed, _, _ = _port_trainer(jax_run, "float32")
    restore_train_state(ckpts, resumed)
    assert resumed.step == 1 and ckpts.latest_step("nets") == 1
    step(resumed, frozen, batch)
    assert resumed.step == state.step == 2
    for a, b in zip(_state_dicts(state), _state_dicts(resumed)):
        for net in a:
            for key in a[net]:
                assert torch.equal(a[net][key], b[net][key]), (net, key)
    for net in state.optims:
        sa, sb = state.optims[net].state_dict()["state"], resumed.optims[net].state_dict()["state"]
        for i in sa:
            for k in sa[i]:
                assert torch.equal(torch.as_tensor(sa[i][k]), torch.as_tensor(sb[i][k])), (net, i, k)


def test_remat_is_not_ported():
    from ppvision_tpu_torch.config import TrainConfig
    from ppvision_tpu_torch.train.gan import make_train_step

    with pytest.raises(NotImplementedError):
        make_train_step(dataclasses.replace(_port_cfg("float32"), train=TrainConfig(remat=True)))


def test_pretrained_files_load_and_absent_ones_warn(tmp_path, capsys):
    """Reference-format files load straight into the port's modules; an
    absent file leaves the seeded init and warns."""
    from ppvision_tpu_torch.config import PathsConfig, TrainConfig
    from ppvision_tpu_torch.models.fan import FAN
    from ppvision_tpu_torch.models.stargan import init_params_
    from ppvision_tpu_torch.optics.camera import Camera, CameraSpec
    from ppvision_tpu_torch.train.pretrained import build_aux_losses, load_frozen_nets

    spec = CameraSpec(n=IMG, zernike_terms=TERMS)
    camera, fan_priv = Camera(spec, seed=9), init_params_(FAN(), 11, gain=1.0)
    wing = tmp_path / "Model_wing.pth"
    # DataParallel-saved modules carry a "module." prefix; the loader drops it.
    torch.save({"Camera": camera.state_dict(),
                "Decoder": {f"module.{k}": v for k, v in fan_priv.state_dict().items()}}, wing)
    paths = PathsConfig(camera_ckpt=str(wing), wing_path=str(tmp_path / "absent.ckpt"),
                        raft_path=str(tmp_path / "absent.pth"))
    cfg = dataclasses.replace(_port_cfg("float32"), paths=paths, train=TrainConfig(flow_iters=1))
    frozen = load_frozen_nets(cfg, 0, device="cpu")
    assert torch.equal(frozen.camera.Zer_train, camera.Zer_train)
    for k, v in fan_priv.state_dict().items():
        assert torch.equal(frozen.fan_priv.state_dict()[k], v), k
    assert all(not p.requires_grad for p in frozen.fan.parameters())
    lpips_fn, flow_fn = build_aux_losses(cfg, 0, device="cpu")
    err = capsys.readouterr().err
    for what in ("FAN (wing.ckpt)", "LPIPS", "RAFT"):
        assert f"WARNING: {what}" in err, what
    assert "camera+fan_priv" not in err
    x = torch.rand(1, IMG, IMG, 3)
    assert float(lpips_fn(x, x)) == 0.0
    assert torch.isfinite(flow_fn(255 * x, 255 * x))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_discriminator_matches_jax(compute_dtype):
    """Logits and the R1 input gradient of the port's Discriminator on
    the JAX package's parameters; bf16 against JAX's own bf16-vs-f32 gap."""
    from ppvision_tpu.models.stargan import Discriminator as JD
    from ppvision_tpu_torch.models.stargan import Discriminator

    rng = np.random.default_rng(3)
    x = rng.random((3, IMG, IMG, 3)).astype(np.float32)
    y = np.array([0, 1, 1], np.int32)
    jd = JD(img_size=IMG, max_conv_dim=32)
    params = jax.jit(jd.init)(jax.random.key(4), jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1,), jnp.int32))["params"]

    def jax_out(dtype):
        d = JD(img_size=IMG, max_conv_dim=32, dtype=jnp.dtype(dtype))
        out = d.apply({"params": params}, jnp.asarray(x), jnp.asarray(y))
        gx = jax.grad(lambda v: jnp.sum(d.apply({"params": params}, v, jnp.asarray(y))))(jnp.asarray(x))
        return np.asarray(out), np.asarray(gx)

    port = Discriminator(img_size=IMG, max_conv_dim=32, dtype=getattr(torch, compute_dtype))
    port.load_state_dict(jax_params.discriminator_state_dict(numpy_tree(params)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    out = port(xt, torch.from_numpy(y).long())
    (gx,) = torch.autograd.grad(out.sum(), xt)
    got = (out.detach().numpy(), gx.permute(0, 2, 3, 1).numpy())
    j32 = jax_out("float32")
    if compute_dtype == "float32":
        for g, w in zip(got, j32):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * float(np.abs(w).max()))
    else:
        j16 = jax_out("bfloat16")
        for g, w16, w32 in zip(got, j16, j32):
            gap = float(np.abs(w16 - w32).max())
            assert float(np.abs(g - w16).max()) <= 1.5 * gap + 1e-6, (float(np.abs(g - w16).max()), gap)


# ---------------------------------------------------------------------------
# The four kernel Functions, through their plain forwards at f64.
# ---------------------------------------------------------------------------


def _f64(*shape, seed=0):
    g = torch.Generator().manual_seed(seed + sum(shape))
    return torch.randn(shape, generator=g, dtype=torch.float64, requires_grad=True)


def test_conv3x3_function_grad_and_gradgrad():
    from ppvision_tpu_torch.ops.winograd import Conv3x3Fn, conv3x3_ref, pack_conv3x3_weight, unpack_conv3x3_weight

    x, w = _f64(2, 4, 5, 4), _f64(3, 3, 4, 3, seed=1)

    def fn(x, w):
        return Conv3x3Fn.apply(x, w, None, lambda x, w, p: conv3x3_ref(x, w))

    assert torch.autograd.gradcheck(fn, (x, w))
    assert torch.autograd.gradgradcheck(fn, (x, w))
    # With the packed copy alone the gradient reaches x only.
    x, packed = _f64(1, 3, 4, 16), pack_conv3x3_weight(_f64(3, 3, 16, 2, seed=1).detach())

    def fn_packed(x):
        return Conv3x3Fn.apply(x, None, packed, lambda x, w, p: conv3x3_ref(x, unpack_conv3x3_weight(p, x.shape[-1])))

    assert torch.autograd.gradcheck(fn_packed, (x,))


def test_instats_function_grad():
    from ppvision_tpu_torch.ops.instats import MomentsFn, _moments_ref

    x = _f64(2, 4, 5, 3)
    assert torch.autograd.gradcheck(lambda x: MomentsFn.apply(x, _moments_ref), (x,))
    assert torch.autograd.gradgradcheck(lambda x: MomentsFn.apply(x, _moments_ref), (x,))


def test_fftconv_function_grad():
    from ppvision_tpu_torch.ops.fftconv import FFTConvFn, fftconv_circular_ref

    args = (_f64(2, 8, 8, 3), _f64(8, 8, 3, seed=1), _f64(8, 8, 3, seed=2))
    assert torch.autograd.gradcheck(lambda *a: FFTConvFn.apply(*a, fftconv_circular_ref), args)


def test_denseblock_function_grad():
    from ppvision_tpu_torch.ops.denseblock import DenseBlockFn, _plain

    f = 8
    ks = (_f64(3, 3, f, f // 2, seed=1), _f64(3, 3, f // 2, f // 4, seed=2), _f64(3, 3, f // 4, f // 4, seed=3))
    bns = [_f64(c, seed=4 + i) for i, c in enumerate((f, f, f // 2, f // 2, f // 4, f // 4))]
    assert torch.autograd.gradcheck(lambda x, *a: DenseBlockFn.apply(_plain, x, *a), (_f64(1, 4, 4, f), *ks, *bns))
