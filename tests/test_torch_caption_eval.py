"""The port's caption evaluation against the JAX package's, at f64.

At ``tests/test_caption_eval.py``'s sizes (ResNet stages (1, 1, 1, 1) on
32^2 images, encoded 3x3, width 8, a 24-word vocabulary, beam 3, 6
steps) with the lens at ``LensSpec(64, 32, 16, height_tolerance=0)``, on
a 3-image in-memory dataset (2 captions an image):

- ``evaluate_captions`` in the ``lens``, ``none`` and ``lowres`` camera
  modes: identical hypotheses, the text scores equal and PSNR/SSIM
  within 1e-9, and the reports it writes;
- ``validate_teacher_forced``: loss and top-5 within 1e-9, BLEU-4 equal;
- ``caption_image_with_attention``: the words identical, the alphas and
  the sensor image within 1e-9; ``render_attention_grid`` writes the grid.

The JAX runs use ``test_torch_captioner.x64_jax`` (its beam search's
f32 score carry read as f64).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppvision_tpu_torch.config import CaptionConfig
from ppvision_tpu_torch.models.captioner import AttentionLSTMDecoder
from ppvision_tpu_torch.models.resnet import CaptionEncoder
from ppvision_tpu_torch.optics import lens as tl
from ppvision_tpu_torch.utils import jax_params

from .test_torch_captioner import f64_tree, x64_jax
from .torch_parity import stand_in_kernels, two_threads  # noqa: F401

VOCAB = 24
WORD_MAP = {f"w{i}": i for i in range(1, VOCAB - 3)}
WORD_MAP.update({"<unk>": VOCAB - 3, "<start>": VOCAB - 2, "<end>": VOCAB - 1, "<pad>": 0})
STAGES = (1, 1, 1, 1)
CFG = dict(emb_dim=8, attention_dim=8, decoder_dim=8, encoded_image_size=3, beam_size=3, max_caption_len=6)
SPEC = dict(wave_res=64, patch_size=32, zernike_terms=16, height_tolerance=0.0)
MODES = ("lens", "none", "lowres")
TOL = 1e-9


class ArrayCaptions:
    """A caption dataset in memory: ``cpi`` captions an image, items as
    ``CaptionDataset`` gives them for VAL/TEST."""

    def __init__(self, images: np.ndarray, captions: np.ndarray, caplens: np.ndarray, cpi: int):
        self.images, self.captions, self.caplens, self.cpi = images, captions, caplens, cpi
        self.split = "TEST"

    def __len__(self):
        return len(self.captions)

    def __getitem__(self, i: int):
        lo = (i // self.cpi) * self.cpi
        return self.images[i // self.cpi], self.captions[i], self.caplens[i], self.captions[lo : lo + self.cpi]


def _dataset() -> ArrayCaptions:
    rng = np.random.default_rng(11)
    images = rng.random((3, 32, 32, 3))
    caps = np.zeros((6, 8), np.int32)
    lens = rng.integers(3, 9, 6).astype(np.int32)
    for i, n in enumerate(lens):
        caps[i, 0], caps[i, n - 1] = WORD_MAP["<start>"], WORD_MAP["<end>"]
        caps[i, 1 : n - 1] = rng.integers(1, 6, n - 2)  # a small vocabulary: n-grams recur
    return ArrayCaptions(images, caps, lens, cpi=2)


def _val_batches(ds: ArrayCaptions) -> list[dict]:
    idx = np.arange(len(ds))
    items = [ds[int(i)] for i in idx]
    return [dict(images=np.stack([it[0] for it in items]), captions=np.stack([it[1] for it in items]),
                 caption_lengths=np.asarray([it[2] for it in items], np.int32),
                 all_captions=np.stack([it[3] for it in items]))]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    from ppvision_tpu.cli.caption_image import caption_image_with_attention
    from ppvision_tpu.config import CaptionConfig as JCfg
    from ppvision_tpu.metrics.eval_caption import evaluate_captions
    from ppvision_tpu.metrics.val_caption import validate_teacher_forced
    from ppvision_tpu.models.captioner import AttentionLSTMDecoder as JDec
    from ppvision_tpu.models.resnet import CaptionEncoder as JEnc
    from ppvision_tpu.optics import lens as jl

    with x64_jax():
        cfg = JCfg(**CFG)
        enc = JEnc(encoded_image_size=3, stage_sizes=STAGES)
        dec = JDec(vocab_size=VOCAB, embed_dim=8, decoder_dim=8, attention_dim=8)
        enc_vars = f64_tree(jax.jit(enc.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3))))
        dparams = f64_tree(jax.jit(dec.init)(jax.random.key(1), jnp.zeros((1, 3, 3, 2048)),
                                             jnp.zeros((1, 4), jnp.int32), jnp.asarray([4]))["params"])
        spec = jl.LensSpec(**SPEC)
        camera = (jl.LensParams(*(jnp.asarray(np.asarray(a), jnp.float64) for a in jl.init_lens_params(spec))),
                  jl.make_lens_constants(spec, dtype=np.float64), spec)
        ds = _dataset()
        out_dir = tmp_path_factory.mktemp("jax_eval")
        evals = {m: evaluate_captions(cfg, enc, dec, enc_vars, dparams, camera, ds, WORD_MAP, camera_mode=m,
                                      batch_size=2, out_dir=str(out_dir / m)) for m in MODES}
        hyps = {m: (out_dir / m / "Captions.txt").read_text() for m in MODES}
        val = validate_teacher_forced(cfg, enc, dec, enc_vars, dparams, camera, _val_batches(ds), WORD_MAP)
        words, alphas, shown = caption_image_with_attention(cfg, enc, dec, enc_vars, dparams, camera,
                                                            ds.images[1], WORD_MAP, beam_size=3)
    return dict(enc_vars=enc_vars, dparams=dparams, evals=evals, hyps=hyps, val=val,
                image=(words, np.asarray(alphas), np.asarray(shown)))


@pytest.fixture(scope="module")
def port(jax_run):
    enc = CaptionEncoder(3, STAGES).double()
    enc.load_state_dict(jax_params.caption_encoder_state_dict(jax_run["enc_vars"], STAGES), strict=True)
    dec = AttentionLSTMDecoder(VOCAB, 8, 8, 8).double()
    dec.load_state_dict(jax_params.decoder_state_dict(jax_run["dparams"]), strict=True)
    spec = tl.LensSpec(**SPEC)
    camera = (tl.init_lens_params(spec).double(), tl.make_lens_constants(spec, dtype=torch.float64), spec)
    return CaptionConfig(**CFG), enc, dec, camera


def _same_scores(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        if k in ("psnr", "ssim"):
            np.testing.assert_allclose(got[k], w, rtol=TOL, atol=TOL, err_msg=k)
        else:
            assert got[k] == w, (k, got[k], w)


@pytest.mark.parametrize("mode", MODES)
def test_evaluate_captions_matches_jax(jax_run, port, mode, tmp_path):
    from ppvision_tpu_torch.metrics.eval_caption import evaluate_captions

    cfg, enc, dec, camera = port
    got = evaluate_captions(cfg, enc, dec, camera, _dataset(), WORD_MAP, camera_mode=mode, batch_size=2,
                            out_dir=str(tmp_path))
    assert (tmp_path / "Captions.txt").read_text() == jax_run["hyps"][mode]
    _same_scores(got, jax_run["evals"][mode])
    assert ("psnr" in got) == (mode == "lens")
    assert json.loads((tmp_path / "metrics.json").read_text()) == pytest.approx(got)
    assert (tmp_path / "Metrics.txt").read_text().count("@ beam size 3") == len(got)


def test_decode_then_score_is_evaluate_captions(port):
    """The device half and the host half in turn give the same results."""
    from ppvision_tpu_torch.metrics import eval_caption as ec

    cfg, enc, dec, camera = port
    decoded = ec.decode_captions(cfg, enc, dec, camera, _dataset(), WORD_MAP, batch_size=2)
    assert len(decoded["hypotheses"]) == 3 and len(decoded["references"][0]) == 2 and len(decoded["psnrs"]) == 3
    assert ec.score_captions(decoded) == ec.evaluate_captions(cfg, enc, dec, camera, _dataset(), WORD_MAP,
                                                              batch_size=2)


def test_decode_captions_names_its_parts(port):
    """``decode_captions`` runs the camera, the encoder, the beam search and
    the image metrics in ``record_function`` ranges, which
    ``chip_smoke.device_ms_by_span`` splits a profile's time by."""
    import chip_smoke
    from ppvision_tpu_torch.metrics import eval_caption as ec

    cfg, enc, dec, camera = port
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ec.decode_captions(cfg, enc, dec, camera, _dataset(), WORD_MAP, batch_size=2)
    by_span, by_node = chip_smoke.device_ms_by_span(stand_in_kernels(prof.events()), chip_smoke.CAPTION_EVAL_SPANS)
    assert set(chip_smoke.CAPTION_EVAL_SPANS) <= set(by_span) and not by_node
    assert all(by_span[s] > 0 for s in chip_smoke.CAPTION_EVAL_SPANS)


def test_validate_teacher_forced_matches_jax(jax_run, port):
    from ppvision_tpu_torch.metrics.val_caption import validate_teacher_forced

    cfg, enc, dec, camera = port
    got = validate_teacher_forced(cfg, enc, dec, camera, _val_batches(_dataset()), WORD_MAP)
    want = jax_run["val"]
    assert set(got) == set(want) and got["bleu4"] == want["bleu4"]
    for k in ("loss", "top5"):
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, err_msg=k)


def test_caption_image_with_attention_matches_jax(jax_run, port, tmp_path):
    from ppvision_tpu_torch.cli.caption_image import caption_image_with_attention, render_attention_grid

    cfg, enc, dec, camera = port
    words, alphas, shown = caption_image_with_attention(cfg, enc, dec, camera, _dataset().images[1], WORD_MAP,
                                                        beam_size=3)
    w_words, w_alphas, w_shown = jax_run["image"]
    assert words == w_words
    np.testing.assert_allclose(alphas, w_alphas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(shown, w_shown, rtol=TOL, atol=TOL)
    out = tmp_path / "att.png"
    render_attention_grid(shown, words, alphas, str(out), enc_size=3)
    from PIL import Image

    with Image.open(out) as im:
        assert im.size == (5 * 32, 32 * -(-(len(words) + 1) // 5))
