"""The port's caption trainer (train/caption.py) against the JAX package's.

Two steps of ``make_caption_train_step`` at ``tests/test_train_caption.py``'s
sizes (width 16, encoded 4x4, ResNet stages (1, 1, 1, 1), the lens at
``LensSpec(64, 32, 16)``, 10 tokens, ``camera_lr`` 1e-2 so that one step
moves the defocus) run on both packages at f64 from the same parameters
and batches.  Dropout is 0 and the lens's height tolerance 0, because
the two packages draw their noise from different generators.  The
metrics of both steps, and every parameter and BN statistic after them,
are held within 1e-8.

B is 4, not that file's 2: at B = 2 the 1x1 trunk output's BNs normalize
two values, which come out +-1 whatever the input, so the gradients into
the trunk are cancellation residue near Adam's eps (1e-8), where the two
frameworks' roundings move an element by up to 9e-8 after two steps
while the metrics agree to 1e-15.  The n = 2 BN statistics are held in
``test_torch_captioner.py``.  Also: dropout and height noise drawn from
one ``torch.Generator`` are reproducible, ``remat`` gives the plain
step's result bit for bit, the frozen stem does not move and
``camera_train=False`` keeps the lens.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppvision_tpu_torch.config import CaptionConfig
from ppvision_tpu_torch.optics.lens import LensSpec, make_lens_constants
from ppvision_tpu_torch.train.caption import init_caption, make_caption_train_step, make_optimizers
from ppvision_tpu_torch.utils import jax_params

from .torch_parity import numpy_tree, stand_in_kernels, two_threads  # noqa: F401

VOCAB = 30
STAGES = (1, 1, 1, 1)
B = 4
LENGTHS = [10, 6, 9, 3]
CFG = dict(emb_dim=16, attention_dim=16, decoder_dim=16, encoded_image_size=4, batch_size=B, camera_lr=1e-2,
           dropout=0.0)
SPEC = dict(wave_res=64, patch_size=32, zernike_terms=16, height_tolerance=0.0)
TOL = 1e-8
METRICS = ("loss", "ce", "dsr", "top5", "ssim", "psf_loss")


@contextlib.contextmanager
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _batches(n: int, dtype=np.float64) -> list[dict]:
    rng = np.random.default_rng(7)
    return [dict(images=rng.random((B, 32, 32, 3)).astype(dtype),
                 captions=rng.integers(0, VOCAB, (B, 10)).astype(np.int32),
                 caption_lengths=np.asarray(LENGTHS, np.int32)) for _ in range(n)]


@pytest.fixture(scope="module")
def jax_run():
    """Two JAX steps at f64 from ``init_caption``'s parameters (inits
    jitted), with the state they start from and end at, as numpy."""
    with _x64():
        from ppvision_tpu.config import CaptionConfig as JCfg
        from ppvision_tpu.models.captioner import AttentionLSTMDecoder
        from ppvision_tpu.models.resnet import CaptionEncoder
        from ppvision_tpu.optics import lens as jl
        from ppvision_tpu.train.caption import CaptionTrainState, make_caption_train_step as jstep
        from ppvision_tpu.train.caption import make_optimizers as jopt

        cfg = JCfg(**CFG)
        spec = jl.LensSpec(**SPEC)
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
        encoder = CaptionEncoder(encoded_image_size=4, stage_sizes=STAGES)
        decoder = AttentionLSTMDecoder(vocab_size=VOCAB, embed_dim=16, decoder_dim=16, attention_dim=16,
                                       dropout=0.0)
        ke, kd = jax.random.split(jax.random.key(0))
        enc_vars = f64(dict(jax.jit(lambda k: encoder.init(k, jnp.zeros((1, 32, 32, 3)), train=False))(ke)))
        dec_params = f64(jax.jit(decoder.init)(kd, jnp.zeros((1, 4, 4, 2048)), jnp.zeros((1, 5), jnp.int32),
                                               jnp.asarray([5]))["params"])
        camera = f64(jl.init_lens_params(spec))
        o_cam, o_enc, o_dec = jopt(cfg)
        state = CaptionTrainState(camera=camera, encoder=enc_vars, decoder=dec_params,
                                  opt_camera=o_cam.init(camera), opt_encoder=o_enc.init(enc_vars["params"]),
                                  opt_decoder=o_dec.init(dec_params), step=jnp.zeros((), jnp.int32))
        step = jstep(encoder, decoder, cfg, spec, jl.make_lens_constants(spec, dtype=np.float64))
        start = numpy_tree(state)
        metrics = []
        for b in _batches(2):
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.key(3))
            metrics.append({k: float(v) for k, v in m.items()})
        return start, numpy_tree(state), metrics


def _port_state(start, dtype=torch.float64, cfg=None):
    cfg = cfg or CaptionConfig(**CFG)
    state = init_caption(0, cfg, VOCAB, LensSpec(**SPEC), encoder_stages=STAGES, device="cpu")
    for m in (state.camera, state.encoder, state.decoder):
        m.to(dtype)
    state.opt_camera, state.opt_encoder, state.opt_decoder = make_optimizers(
        cfg, state.camera, state.encoder, state.decoder)
    if start is not None:
        jax_params.load_caption_params(state, start)
    return state


def _tensors(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _flat(state) -> dict[str, torch.Tensor]:
    out = {f"camera.{k}": v for k, v in state.camera.state_dict().items()}
    out.update({f"encoder.{k}": v for k, v in state.encoder.state_dict().items()})
    out.update({f"decoder.{k}": v for k, v in state.decoder.state_dict().items()})
    return out


def test_two_f64_steps_match_jax(jax_run):
    start, end, jmetrics = jax_run
    state = _port_state(start)
    spec = LensSpec(**SPEC)
    step = make_caption_train_step(CaptionConfig(**CFG), spec, make_lens_constants(spec, dtype=torch.float64))
    gen = torch.Generator().manual_seed(0)
    for b, want in zip(_batches(2), jmetrics):
        got = step(state, _tensors(b), gen)
        for k in METRICS:
            assert abs(float(got[k]) - want[k]) <= TOL * max(1.0, abs(want[k])), (k, float(got[k]), want[k])
    assert state.step == 2
    want_sd = {f"camera.{k}": v for k, v in jax_params.lens_state_dict(end.camera).items()}
    want_sd.update({f"encoder.{k}": v for k, v in
                    jax_params.caption_encoder_state_dict(end.encoder, STAGES).items()})
    want_sd.update({f"decoder.{k}": v for k, v in jax_params.decoder_state_dict(end.decoder).items()})
    got_sd = _flat(state)
    assert set(got_sd) == set(want_sd)
    worst = {}
    for k, v in got_sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        w = want_sd[k].numpy()
        worst[k] = float(np.abs(v.numpy() - w).max() / max(1.0, np.abs(w).max()))
    bad = {k: e for k, e in worst.items() if not e <= TOL}
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])[:5]
    # The defocus moved; the stem and layer1 did not; the BN statistics did.
    start_sd = _flat(_port_state(start))
    assert not torch.equal(got_sd["camera.zernike_coeffs_train"], start_sd["camera.zernike_coeffs_train"])
    assert torch.equal(got_sd["encoder.conv1.weight"], start_sd["encoder.conv1.weight"])
    assert torch.equal(got_sd["encoder.layer1.0.conv2.weight"], start_sd["encoder.layer1.0.conv2.weight"])
    assert not torch.equal(got_sd["encoder.layer2.0.conv2.weight"], start_sd["encoder.layer2.0.conv2.weight"])
    assert not torch.equal(got_sd["encoder.bn1.running_var"], start_sd["encoder.bn1.running_var"])


def _one_step(cfg, spec_kw, seed: int, camera_train: bool = True):
    spec = LensSpec(**spec_kw)
    state = _port_state(None, torch.float32, cfg)
    step = make_caption_train_step(cfg, spec, make_lens_constants(spec), camera_train=camera_train)
    metrics = step(state, _tensors(_batches(1, np.float32)[0]), torch.Generator().manual_seed(seed))
    return state, metrics


def test_dropout_and_height_noise_come_from_the_generator():
    """Dropout 0.5 and the lens's 2e-8 m tolerance: one generator seed
    gives the same step twice, another seed another."""
    cfg = CaptionConfig(**dict(CFG, dropout=0.5))
    spec = dict(SPEC, height_tolerance=2e-8)
    (a, ma), (b, mb), (c, mc) = (_one_step(cfg, spec, s) for s in (1, 1, 2))
    fa, fb, fc = _flat(a), _flat(b), _flat(c)
    assert all(torch.equal(fa[k], fb[k]) for k in fa) and float(ma["loss"]) == float(mb["loss"])
    assert float(ma["loss"]) != float(mc["loss"])
    assert not torch.equal(fa["decoder.fc.weight"], fc["decoder.fc.weight"])


def test_remat_step_equals_the_plain_step():
    cfg = CaptionConfig(**CFG)
    plain, mp_ = _one_step(cfg, SPEC, 0)
    remat, mr = _one_step(dataclasses.replace(cfg, remat=True), SPEC, 0)
    fp, fr = _flat(plain), _flat(remat)
    assert all(torch.equal(fp[k], fr[k]) for k in fp)
    assert all(float(mp_[k]) == float(mr[k]) for k in METRICS)


def test_camera_train_false_keeps_the_lens():
    cfg = CaptionConfig(**CFG)
    state, _ = _one_step(cfg, SPEC, 0, camera_train=False)
    assert float(state.camera.zernike_coeffs_train.detach()) == LensSpec().defocus_init


def test_step_names_its_parts():
    """The step's forward parts and optimizer run in ``record_function``
    ranges, and its backward under autograd's node names, which
    ``chip_smoke.device_ms_by_span`` splits a profile's time by (CPU self
    time standing in for the card's kernels)."""
    import chip_smoke

    cfg = CaptionConfig(**CFG)
    spec = LensSpec(**SPEC)
    state = _port_state(None, torch.float32, cfg)
    step = make_caption_train_step(cfg, spec, make_lens_constants(spec))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, _tensors(_batches(1, np.float32)[0]), torch.Generator().manual_seed(0))
    by_span, by_node = chip_smoke.device_ms_by_span(stand_in_kernels(prof.events()), chip_smoke.CAPTION_TRAIN_SPANS)
    assert all(by_span.get(s, 0) > 0 for s in (*chip_smoke.CAPTION_TRAIN_SPANS, "backward"))
    assert "ConvolutionBackward0" in by_node and len(by_node) == 10  # the ten largest autograd nodes
