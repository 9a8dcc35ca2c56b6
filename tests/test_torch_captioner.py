"""The port's caption encoder and decoder against the JAX package's, at f64.

At ``tests/test_caption_eval.py``'s sizes (ResNet stages (1, 1, 1, 1) on
32^2 images, encoded 3x3; emb, attention and decoder width 8; a
24-word vocabulary), with the JAX trees carried over through
``utils/jax_params.py``, all within 1e-8:

- the encoder in eval mode (running statistics), and in train mode with
  the new BN statistics (Flax's biased variance, momentum 0.9);
- the decoder's predictions and alphas with unequal caption lengths, the
  loop stopping early where every caption ended, and ``caption_loss``;
- ``beam_search_batch`` on 2 images: tokens identical, scores within
  1e-9.  The JAX beam search keeps its -1e9 score carry in f32, which
  meets an f64 carry under x64; the fixture gives its module an f64
  ``float32`` (the value -1e9 is exact in both).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppvision_tpu.models import captioner as jcap
from ppvision_tpu.models.resnet import CaptionEncoder as JaxEncoder
from ppvision_tpu_torch.models.captioner import (
    AttentionLSTMDecoder,
    beam_search,
    beam_search_batch,
    caption_loss,
)
from ppvision_tpu_torch.models.resnet import CaptionEncoder, adaptive_avg_pool, commit_batch_stats
from ppvision_tpu_torch.utils import jax_params

from .torch_parity import numpy_tree, two_threads  # noqa: F401

VOCAB = 24
STAGES = (1, 1, 1, 1)
ENC_IMG = 3
TOL = 1e-8
START, END = VOCAB - 2, VOCAB - 1


@contextlib.contextmanager
def x64_jax():
    """JAX x64 on for the block, with the captioner module's ``float32``
    read as f64 (see the module docstring)."""

    class _Jnp:
        def __getattr__(self, k):
            return jnp.float64 if k == "float32" else getattr(jnp, k)

    jax.config.update("jax_enable_x64", True)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jcap, "jnp", _Jnp())
            yield
    finally:
        jax.config.update("jax_enable_x64", False)


def f64_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def close(got, want, what: str, tol: float = TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (what, err)


@pytest.fixture(scope="module")
def jax_run():
    with x64_jax():
        enc = JaxEncoder(encoded_image_size=ENC_IMG, stage_sizes=STAGES)
        variables = f64_tree(jax.jit(enc.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3))))
        # Running statistics away from their 0/1 init, so eval mode uses them.
        rng = np.random.default_rng(0)
        variables = {"params": variables["params"], "batch_stats": jax.tree_util.tree_map(
            lambda a: rng.uniform(0.5, 1.5, a.shape), variables["batch_stats"])}
        images = rng.random((2, 32, 32, 3))
        enc_eval = np.asarray(jax.jit(lambda v, x: enc.apply(v, x, train=False))(variables, images))
        enc_train, mut = jax.jit(lambda v, x: enc.apply(v, x, train=True, mutable=["batch_stats"]))(variables, images)

        dec = jcap.AttentionLSTMDecoder(vocab_size=VOCAB, embed_dim=8, decoder_dim=8, attention_dim=8)
        dparams = f64_tree(jax.jit(dec.init)(
            jax.random.key(1), jnp.zeros((1, ENC_IMG, ENC_IMG, 2048)), jnp.zeros((1, 4), jnp.int32),
            jnp.asarray([4]),
        )["params"])
        feats = rng.standard_normal((3, ENC_IMG, ENC_IMG, 2048))
        caps = rng.integers(1, VOCAB - 3, (3, 8)).astype(np.int32)
        caps[:, 0] = START
        decoded = {}
        for name, lens in (("full", [8, 5, 3]), ("short", [5, 3, 2])):
            lens = np.asarray(lens, np.int32)
            out = dec.apply({"params": dparams}, feats, caps, lens)
            ce, dsr, acc5 = jcap.caption_loss(out, caps, 1.0)
            decoded[name] = dict(lens=lens, preds=np.asarray(out.predictions), alphas=np.asarray(out.alphas),
                                 loss=(float(ce), float(dsr), float(acc5)))
        bs_tokens, bs_scores = jcap.beam_search_batch(dec, dparams, feats[:2], START, END, 3, 6)
        return dict(variables=variables, images=images, enc_eval=enc_eval, enc_train=np.asarray(enc_train),
                    new_stats=numpy_tree(mut["batch_stats"]), dparams=dparams, feats=feats, caps=caps,
                    decoded=decoded, bs=(np.asarray(bs_tokens), np.asarray(bs_scores)))


def port_encoder(jr) -> CaptionEncoder:
    enc = CaptionEncoder(ENC_IMG, STAGES).double()
    enc.load_state_dict(jax_params.caption_encoder_state_dict(jr["variables"], STAGES), strict=True)
    return enc


def port_decoder(jr) -> AttentionLSTMDecoder:
    dec = AttentionLSTMDecoder(VOCAB, 8, 8, 8).double()
    dec.load_state_dict(jax_params.decoder_state_dict(jr["dparams"]), strict=True)
    return dec.eval()


def test_encoder_eval_mode_matches_jax(jax_run):
    enc = port_encoder(jax_run).eval()
    with torch.no_grad():
        got = enc(torch.from_numpy(jax_run["images"]))
    assert got.shape == (2, ENC_IMG, ENC_IMG, 2048) and got.dtype == torch.float64
    close(got, jax_run["enc_eval"], "encoder eval")


def test_encoder_train_mode_and_bn_statistics_match_jax(jax_run):
    enc = port_encoder(jax_run).train()
    with torch.no_grad():
        got = enc(torch.from_numpy(jax_run["images"]))
    close(got, jax_run["enc_train"], "encoder train")
    before = {k: v.clone() for k, v in enc.state_dict().items() if "running" in k}
    commit_batch_stats(enc)
    sd = enc.state_dict()
    want = jax_params.caption_encoder_state_dict(
        {"params": jax_run["variables"]["params"], "batch_stats": jax_run["new_stats"]}, STAGES
    )
    for k in before:
        close(sd[k], want[k].numpy(), k)
        assert not torch.equal(sd[k], before[k]), k
    # Committing again without a forward changes nothing.
    commit_batch_stats(enc)
    assert all(torch.equal(enc.state_dict()[k], sd[k]) for k in before)


@pytest.mark.parametrize("case", ["full", "short"])
def test_decoder_and_caption_loss_match_jax(jax_run, case):
    d = jax_run["decoded"][case]
    dec = port_decoder(jax_run)
    caps = torch.from_numpy(jax_run["caps"])
    with torch.no_grad():
        out = dec(torch.from_numpy(jax_run["feats"]), caps, torch.from_numpy(d["lens"]))
        loss = caption_loss(out, caps, 1.0)
    close(out.predictions, d["preds"], "predictions")
    close(out.alphas, d["alphas"], "alphas")
    for name, g, w in zip(("ce", "dsr", "top5"), loss, d["loss"]):
        np.testing.assert_allclose(float(g), w, rtol=TOL, atol=TOL, err_msg=name)
    # Inactive steps are exactly zero.
    last = int(d["lens"][-1]) - 1
    assert float(out.predictions[-1, last:].abs().max()) == 0.0 and float(out.alphas[-1, last:].abs().max()) == 0.0


def test_beam_search_batch_matches_jax(jax_run):
    dec = port_decoder(jax_run)
    want_tokens, want_scores = jax_run["bs"]
    feats = torch.from_numpy(jax_run["feats"][:2])
    tokens, scores = beam_search_batch(dec, feats, START, END, 3, 6)
    np.testing.assert_array_equal(tokens.numpy(), want_tokens)
    np.testing.assert_allclose(scores.numpy(), want_scores, rtol=1e-9, atol=1e-9)
    # One image alone gives its row of the batch.
    t1, s1 = beam_search(dec, feats[1:2], START, END, 3, 6)
    assert torch.equal(t1, tokens[1]) and abs(float(s1 - scores[1])) <= 1e-12


def test_adaptive_avg_pool_matches_torch_adaptive_avg_pool2d():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 8, 8, 5)))
    got = adaptive_avg_pool(x, (36, 36))
    want = torch.nn.AdaptiveAvgPool2d((36, 36))(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
