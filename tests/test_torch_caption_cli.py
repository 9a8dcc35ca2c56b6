"""The port's caption CLIs (cli/caption.py, cli/caption_image.py) on the CPU.

- Flag parity: each subcommand takes the JAX CLI's option strings, plus
  ``--device`` where it computes.
- ``preprocess`` (plain and ``--custom``) on a tiny Karpathy JSON and a
  folder of PNGs writes the same word map, HDF5 images and caption files
  as the JAX package's.
- Then, with ``_setup`` and ``_lens`` patched to a tiny configuration
  (ResNet stages (1, 1, 1, 1), width 8, the lens at ``LensSpec(64, 32,
  16)``): one ``train`` epoch (its epoch-end eval's BLEU-4 made to pass
  the save gate, so it saves), ``train --resume``, ``eval`` from the
  checkpoint, ``heat`` for 2 steps and ``caption_image``.
"""

import json

import h5py
import numpy as np
import pytest
import torch
from PIL import Image

from ppvision_tpu_torch.cli import caption as cli
from ppvision_tpu_torch.cli import caption_image as cli_image
from ppvision_tpu_torch.config import CaptionConfig
from ppvision_tpu_torch.optics.lens import LensSpec, make_lens_constants
from ppvision_tpu_torch.train.caption import init_caption

from .torch_parity import two_threads  # noqa: F401

TINY_CFG = dict(emb_dim=8, attention_dim=8, decoder_dim=8, encoded_image_size=3, max_caption_len=8)
TINY_LENS = dict(wave_res=64, patch_size=32, zernike_terms=16)
NAME = "coco_2_cap_per_img_0_min_word_freq"
WORDS = ["a", "man", "dog", "on", "the", "grass", "red", "car", "road", "sits"]


def _flags(p) -> set:
    return {s for a in p._actions for s in a.option_strings}


def _subparsers(p) -> dict:
    return next(a for a in p._actions if a.__class__.__name__ == "_SubParsersAction").choices


def test_flags_are_the_jax_clis_plus_device():
    from ppvision_tpu.cli import caption as jcli
    from ppvision_tpu.cli import caption_image as jimg

    mine, theirs = _subparsers(cli.build_parser()), _subparsers(jcli.build_parser())
    assert set(mine) == set(theirs) == {"preprocess", "train", "eval", "heat"}
    for cmd in theirs:
        extra = set() if cmd == "preprocess" else {"--device"}
        assert _flags(mine[cmd]) == _flags(theirs[cmd]) | extra, cmd
    args = cli.build_parser().parse_args(["train"])
    assert args.device == "cuda" and args.batch_size == 64 and args.camera_train is True
    # The JAX caption_image CLI builds its parser inside main(): read its flags from the source.
    import inspect

    src = inspect.getsource(jimg.main)
    jax_flags = {s.split('"')[1] for s in src.split("p.add_argument(")[1:]}
    assert _flags(cli_image.build_parser()) == jax_flags | {"--device", "-h", "--help"}


def _karpathy(root, n_train=4, n_val=2, n_test=2) -> tuple[str, str]:
    """A Karpathy-format JSON and its 40x48 PNGs under ``root``."""
    rng = np.random.default_rng(0)
    images = []
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test), ("restval", 1)):
        for i in range(n):
            name = f"{split}_{i}.png"
            (root / "imgs" / "train2014").mkdir(parents=True, exist_ok=True)
            Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(root / "imgs" / "train2014" / name)
            sents = [{"tokens": list(rng.choice(WORDS, int(rng.integers(3, 7))))} for _ in range(int(rng.integers(1, 4)))]
            images.append({"filepath": "train2014", "filename": name, "split": split, "sentences": sents})
    path = root / "karpathy.json"
    path.write_text(json.dumps({"images": images}))
    return str(path), str(root / "imgs")


def _same_outputs(a, b) -> None:
    files = sorted(p.name for p in a.iterdir())
    assert files == sorted(p.name for p in b.iterdir()) and files
    for name in files:
        if name.endswith(".hdf5"):
            with h5py.File(a / name) as ha, h5py.File(b / name) as hb:
                assert ha.attrs["captions_per_image"] == hb.attrs["captions_per_image"]
                np.testing.assert_array_equal(ha["images"][()], hb["images"][()])
        else:
            assert (a / name).read_text() == (b / name).read_text(), name


@pytest.mark.parametrize("custom", [False, True])
def test_preprocess_writes_what_the_jax_cli_writes(tmp_path, custom):
    from ppvision_tpu.cli import caption as jcli

    js, imgs = _karpathy(tmp_path)
    common = ["preprocess", "--karpathy_json", js, "--image_folder", imgs, "--captions_per_image", "2",
              "--min_word_freq", "0", "--max_len", "8"] + (["--custom", "--train_limit", "3"] if custom else [])
    cli.main([*common, "--output_folder", str(tmp_path / "port")])
    jcli.main([*common, "--output_folder", str(tmp_path / "jax")])
    _same_outputs(tmp_path / "port", tmp_path / "jax")
    splits = {"TRAIN", "VAL"} if custom else {"TRAIN", "VAL", "TEST"}
    assert {p.name.split("_")[0] for p in (tmp_path / "port").glob("*.hdf5")} == splits


def _tiny_lens(device):
    spec = LensSpec(**TINY_LENS)
    return spec, make_lens_constants(spec, device=device)


def _tiny_setup(cfg, vocab_size, device):
    spec, consts = _tiny_lens(device)
    tiny = CaptionConfig(**TINY_CFG)
    return spec, consts, init_caption(0, tiny, vocab_size, spec, encoder_stages=(1, 1, 1, 1), device=device)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("caption_cli")
    js, imgs = _karpathy(root)
    cli.main(["preprocess", "--karpathy_json", js, "--image_folder", imgs, "--captions_per_image", "2",
              "--min_word_freq", "0", "--max_len", "8", "--output_folder", str(root / "data")])
    return root


def test_train_resume_eval_heat_and_caption_image(data, tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "_setup", _tiny_setup)
    monkeypatch.setattr(cli, "_lens", _tiny_lens)
    real_eval = cli.evaluate_captions
    evals = []

    def passing_eval(*a, **kw):  # the epoch-end eval, its BLEU-4 over the save gate
        res = real_eval(*a, **kw)
        evals.append(res)
        return dict(res, bleu4=1.0)

    monkeypatch.setattr(cli, "evaluate_captions", passing_eval)
    steps = []
    real_step = cli.make_caption_train_step

    def counting_step(*a, **kw):
        step = real_step(*a, **kw)

        def run(state, batch, gen):
            steps.append({k: tuple(v.shape) for k, v in batch.items()})
            return step(state, batch, gen)

        return run

    monkeypatch.setattr(cli, "make_caption_train_step", counting_step)
    out = tmp_path / "out"
    common = ["--data_folder", str(data / "data"), "--data_name", NAME, "--out_dir", str(out), "--device", "cpu"]
    state = cli.main(["train", *common, "--epochs", "1", "--batch_size", "2"])
    # 5 TRAIN images (train + restval) x 2 captions = 10 items: 5 steps of 2.
    assert len(steps) == 5 and steps[0]["images"] == (2, 256, 256, 3) and state.step == 5
    assert (out / "000001_caption_state.ckpt").exists() and (out / "metrics.jsonl").exists()
    assert set(evals[0]) >= {"bleu1", "bleu4", "meteor", "rouge_lsum", "cider", "psnr", "ssim"}
    saved = torch.load(out / "000001_caption_state.ckpt", weights_only=True)
    assert all(torch.equal(v, state.decoder.state_dict()[k]) for k, v in saved["decoder"].items())

    steps.clear()
    resumed = cli.main(["train", *common, "--epochs", "2", "--batch_size", "2", "--resume"])
    assert len(steps) == 5 and resumed.step == 10 and (out / "000002_caption_state.ckpt").exists()

    monkeypatch.setattr(cli, "evaluate_captions", real_eval)
    res = cli.main(["eval", *common, "--split", "TEST", "--beam_size", "2", "--max_images", "2"])
    assert json.loads((out / "metrics.json").read_text()) == pytest.approx(res)
    assert len((out / "Captions.txt").read_text().splitlines()) == 2
    # The eval ran on the saved weights: the same eval on a state loaded here.
    word_map = json.loads((data / "data" / f"WORDMAP_{NAME}.json").read_text())
    spec, consts, loaded = _tiny_setup(None, len(word_map) + 1, "cpu")
    loaded.load_state_dict(torch.load(out / "000002_caption_state.ckpt", weights_only=True))
    from ppvision_tpu_torch.data.caption import CaptionDataset

    assert real_eval(CaptionConfig(beam_size=2), loaded.encoder, loaded.decoder, (loaded.camera, consts, spec),
                     CaptionDataset(str(data / "data"), NAME, "TEST"), word_map, beam_size=2, max_images=2) == res

    heat_out = tmp_path / "warmup.pth"
    lens = cli.main(["heat", "--steps", "2", "--img_dir", str(data / "imgs"), "--out", str(heat_out),
                     "--device", "cpu"])
    assert float(lens.defocus.detach()) != LensSpec().defocus_init
    # Warm starts: the heated lens, and a torchvision-style encoder file
    # (its classifier ``fc`` beside the trunk's keys).
    from ppvision_tpu_torch.models.resnet import CaptionEncoder, init_encoder_

    enc_sd = dict(init_encoder_(CaptionEncoder(3, (1, 1, 1, 1)), seed=5).state_dict(),
                  **{"fc.weight": torch.zeros(10, 2048), "fc.bias": torch.zeros(10)})
    torch.save(enc_sd, tmp_path / "resnet.pth")
    warm = cli.main(["train", *common, "--epochs", "0", "--warmup_ckpt", str(heat_out), "--encoder_ckpt",
                     str(tmp_path / "resnet.pth")])
    assert float(warm.camera.defocus.detach()) == float(lens.defocus.detach())
    assert all(torch.equal(v, enc_sd[k]) for k, v in warm.encoder.state_dict().items())

    words, alphas = cli_image.main(["--img", str(data / "imgs" / "train2014" / "test_0.png"), "--data_folder",
                                    str(data / "data"), "--data_name", NAME, "--ckpt_dir", str(out),
                                    "--beam_size", "2", "--out", str(tmp_path / "att.png"), "--device", "cpu"])
    assert (tmp_path / "att.png").exists() and alphas.shape[1] == 9 and alphas.shape[0] - len(words) in (0, 1)
