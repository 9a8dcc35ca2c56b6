"""The plain reference against the port's CPU path at tiny widths.

Both sides get the benchmark's seeded weights and inputs.  The port runs
its plain kernel versions on the CPU in float32; the reference runs
float32 with its optics in float64.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from portbench import inputs, run, weights
from portbench.reference import caption as ref_caption
from portbench.reference import deid as ref_deid
from portbench.reference import optics

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _config(name: str, kind: str) -> dict:
    """A configuration at the toy sizes that its traffic's driver declares."""
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    for k, v in run.load_kind(kind).TOY["config"].items():
        cfg[k] = {**cfg[k], **v} if isinstance(v, dict) else v
    return cfg


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.fixture(scope="module")
def deid():
    from ppvision_tpu_torch.deid import build_deid
    from portbench.kinds.deid_serve import MODULES, _port_config

    torch.manual_seed(0)
    cfg = _config("face_deid_256", "deid_serve")
    bundle = build_deid(5, _port_config(cfg, None), "cpu")
    mods = {k: getattr(bundle, k) for k in MODULES}
    states = weights.make_states({k: {n: t.shape for n, t in m.state_dict().items()} for k, m in mods.items()},
                                 cfg["init"], 5, "cpu")
    for k, m in mods.items():
        m.load_state_dict(states[k])
    n = cfg["model"]["img_size"]
    return cfg, bundle, states, inputs.smooth_images(3, n, 5, "cpu", 1), inputs.smooth_images(2, n, 5, "cpu", 2)


def test_camera_sensor_matches(deid):
    from ppvision_tpu_torch.optics.camera import camera_apply

    cfg, bundle, states, x, _ = deid
    with torch.no_grad():
        got, _ = camera_apply(bundle.camera, bundle.camera_consts, x)
    want, _ = ref_deid.privacy_front(states, cfg, x)
    assert _rel(got, want) < 1e-4


def test_privacy_masks_match(deid):
    from ppvision_tpu_torch.models.fan import get_heatmap

    cfg, bundle, states, x, _ = deid
    sensor, (m1, m2) = ref_deid.privacy_front(states, cfg, x)
    with torch.no_grad():
        g1, g2 = get_heatmap(bundle.fan, sensor, privacy=True)
    # The port folds the head's channel sums into the conv; f32 sums in
    # another order, then a clamp.
    assert (g1.permute(0, 3, 1, 2) - m1).abs().max() < 1e-4
    assert (g2.permute(0, 3, 1, 2) - m2).abs().max() < 1e-4


def test_style_codes_match(deid):
    cfg, bundle, states, _, xr = deid
    y = torch.tensor([0, 1])
    with torch.no_grad():
        got = bundle.style_encoder(xr.permute(0, 3, 1, 2), y)
    want = ref_deid.style_codes(states["style_encoder"], cfg["model"], xr.permute(0, 3, 1, 2), y)
    assert _rel(got, want) < 1e-5


def test_deid_outputs_match(deid):
    from ppvision_tpu_torch.deid import deid_multi_style

    cfg, bundle, states, x, xr = deid
    y = torch.tensor([0, 1])
    got = deid_multi_style(bundle, x, xr, y)
    want = ref_deid.deid_batch(states, cfg, x, xr, y)
    assert got.shape == want.shape == (2, 3, x.shape[1], x.shape[2], 3)
    assert _rel(got, want) < 1e-4
    # Saved-image space: at most a truncation flip a pixel.
    d = (ref_deid.to_uint8(got).int() - ref_deid.to_uint8(want).int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 1e-2


def test_skip_mean_spans_the_whole_batch(deid):
    """One source's outputs depend on its batch-mates (the generator's
    skips are centred on the batch mean): the reference must be run on
    the padded batch the server ran."""
    cfg, _, states, x, xr = deid
    y = torch.tensor([0, 1])
    alone = ref_deid.deid_batch(states, cfg, x[:1], xr, y)[:, 0]
    together = ref_deid.deid_batch(states, cfg, x, xr, y)[:, 0]
    assert _rel(alone, together) > 1e-4


@pytest.fixture(scope="module")
def caption():
    from ppvision_tpu_torch.config import CaptionConfig
    from ppvision_tpu_torch.optics.lens import LensSpec, make_lens_constants
    from ppvision_tpu_torch.train.caption import init_caption, make_caption_train_step
    from portbench.kinds.caption_steps import MODULES, TOY, _batches

    cfg = _config("caption_sat_256", "caption_steps")
    mix = dict(TOY["mix"])
    spec = LensSpec(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg["lens"].items()})
    ccfg = CaptionConfig(**cfg["caption"])
    consts = make_lens_constants(spec, device="cpu")
    state = init_caption(3, ccfg, cfg["vocab_size"], spec, encoder_stages=tuple(cfg["encoder"]["stages"]),
                         device="cpu")
    mods = {k: getattr(state, k) for k in MODULES}
    states = weights.make_states({k: {n: t.shape for n, t in m.state_dict().items()} for k, m in mods.items()},
                                 cfg["init"], 3, "cpu")
    for k, m in mods.items():
        m.load_state_dict(states[k])
    return cfg, spec, consts, state, make_caption_train_step(ccfg, spec, consts), states, _batches(cfg, mix, 3, "cpu", 3)


def test_lens_psf_matches(caption):
    from ppvision_tpu_torch.optics.lens import lens_apply

    cfg, spec, consts, state, _, states, batches = caption
    g1 = torch.Generator().manual_seed(11)
    with torch.no_grad():
        res = lens_apply(state.camera, consts, spec, batches[0]["images"], mask_mode="3", generator=g1)
    cam = states["camera"]
    coeffs = torch.cat([cam["zernike_coeffs_no_train"].reshape(-1), cam["zernike_coeffs_train"].reshape(-1),
                        cam["zernike_coeffs_no_train2"].reshape(-1)])
    noise = torch.rand((spec.wave_res,) * 2, generator=torch.Generator().manual_seed(11))
    psf, loss = optics.lens_psf(coeffs, cfg["lens"], noise)
    assert _rel(res.psf, psf) < 1e-4
    assert float(res.psf_loss) == pytest.approx(float(loss), rel=1e-4)
    assert _rel(res.sensor, optics.lens_sensor(batches[0]["images"], psf)) < 1e-4


def test_encoder_features_match(caption):
    cfg, _, _, state, _, states, batches = caption
    enc = copy.deepcopy(state.encoder).train()
    x = batches[0]["images"]
    with torch.no_grad():
        got = enc(x)
    want = ref_caption.encoder_forward(states["encoder"], x, cfg["caption"]["encoded_image_size"],
                                       cfg["encoder"]["stages"])
    assert _rel(got, want) < 1e-4


def test_three_steps_match(caption):
    """Three train steps of the port against the reference from the same
    weights, batches and generator seed: losses, the first applied
    gradient of every leaf, and the BN statistics after the steps."""
    cfg, _, _, state, step, states, batches = caption
    st = copy.deepcopy(state)
    g = torch.Generator().manual_seed(21)
    losses = [float(step(st, b, g)["loss"]) for b in batches[:1]]
    first = {}
    for m in ("camera", "encoder", "decoder"):
        opt = {"camera": st.opt_camera, "encoder": st.opt_encoder, "decoder": st.opt_decoder}[m]
        for name, p in getattr(st, m).named_parameters():
            if ref_caption.trainable(m, name) and p in opt.state:
                first[(m, name)] = opt.state[p]["exp_avg"] / 0.1
    losses += [float(step(st, b, g)["loss"]) for b in batches[1:]]
    r_losses, r_first, r_state, *_ = ref_caption.train_steps(states, cfg, batches, torch.Generator().manual_seed(21))
    assert losses[0] == pytest.approx(r_losses[0], rel=1e-5)
    assert np.allclose(losses, r_losses, rtol=1e-2)
    for k, want in r_first.items():
        assert _rel(first[k], want) < 1e-3 or float(torch.linalg.vector_norm(want)) < 1e-8, k
    sd = st.encoder.state_dict()
    for k, v in r_state["encoder"].items():
        if k.endswith("running_var"):
            assert _rel(sd[k], v) < 1e-4, k
