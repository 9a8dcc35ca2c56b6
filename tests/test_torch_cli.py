"""The port's Face-DeId CLI (cli/main.py) on the CPU, at a tiny config.

- Flag parity: the JAX CLI's option strings, plus ``--device``.
- ``--mode train`` for 2 iterations writes ``metrics.jsonl`` and the four
  checkpoint groups; a second run resumes at step 2 with the saved state
  bit for bit; the CLI's first iteration equals ``make_train_step`` on
  the first ``FaceBatcher`` batch.
- The slice as a whole against the JAX package: ``--mode sample`` of both
  CLIs on reference-format checkpoint files written from seeded port
  modules and one folder of faces, in f32, within
  ``tests/test_torch_deid.py``'s f32 tolerance.
"""

import copy
import shutil

import jax
import numpy as np
import pytest
import torch

from ppvision_tpu_torch.cli import main as cli

IMG = 32
TINY = ["--img_size", str(IMG), "--fan_input_size", "64", "--max_conv_dim", "32", "--style_dim", "8",
        "--compute_dtype", "float32", "--zernike_terms", "16", "--n", str(IMG)]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this file's small nets: the parallel test
    workers share the host's cores, and more threads a worker only spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _faces(root, seed: int, n: int = 3, hw=(40, 36)) -> str:
    from PIL import Image

    rng = np.random.default_rng(seed)
    for cls in ("female", "male"):
        (root / cls).mkdir(parents=True)
        for i in range(n):
            base = rng.integers(0, 256, (hw[0] // 4, hw[1] // 4, 3), dtype=np.uint8)
            Image.fromarray(base).resize((hw[1], hw[0]), Image.BILINEAR).save(root / cls / f"{i:03d}.png")
    return str(root)


def _train_args(tmp, total: int, ck: str) -> list[str]:
    return ["--mode", "train", *TINY, "--batch_size", "2", "--flow_iters", "1", "--total_iters", str(total),
            "--save_every", "1", "--print_every", "1", "--debug_every", "2", "--train_img_dir", str(tmp / "train"),
            "--ref_dir", str(tmp / "ref"), "--checkpoint_save_dir", ck, "--checkpoint_dir", str(tmp / "none"),
            "--debug_dir", str(tmp / "debug"), "--device", "cpu"]


def test_flags_are_the_jax_clis_plus_device(tmp_path, monkeypatch):
    """The flags, and the dispatch of ``--mode eval`` (which refuses random
    metric nets without ``--allow_random_metrics``) and ``--mode align``."""
    from ppvision_tpu.cli.main import build_parser as jax_parser

    def flags(p):
        return {s for a in p._actions for s in a.option_strings}

    assert flags(cli.build_parser()) == flags(jax_parser()) | {"--device"}
    args = cli.build_parser().parse_args(["--mode", "sample"])
    assert args.device == "cuda" and args.img_size == 256 and args.remat is False
    missing = [a for k in ("lpips_path", "alexnet_path", "inception_path", "arcface_path")
               for a in (f"--{k}", str(tmp_path / "none"))]
    _faces(tmp_path / "val", 6, n=1, hw=(IMG, IMG))
    with pytest.raises(RuntimeError, match="allow_random_metrics"):
        cli.main(["--mode", "eval", *TINY, *missing, "--val_img_dir", str(tmp_path / "val"),
                  "--checkpoint_save_dir", str(tmp_path / "ck"), "--device", "cpu"])
    seen = []
    monkeypatch.setattr(cli, "run_align", lambda *a, **kw: seen.append((a[1:], kw)))
    cli.main(["--mode", "align", "--inp_dir", "faces", "--out_dir", "aligned", "--device", "cpu"])
    assert seen == [(("faces", "aligned"), {"device": "cpu"})]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two CLI iterations on a folder of faces, saving every step."""
    tmp = tmp_path_factory.mktemp("cli")
    _faces(tmp / "train", 0)
    _faces(tmp / "ref", 1)
    ck = str(tmp / "ckpt")
    state = cli.main(_train_args(tmp, 2, ck))
    return tmp, ck, state


def test_train_writes_metrics_checkpoints_and_debug_grid(trained):
    import json

    from ppvision_tpu_torch.utils.checkpoint import StepCheckpoints

    tmp, ck, state = trained
    assert state.step == 2
    lines = [json.loads(s) for s in (tmp / "ckpt" / "metrics.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines] == [1, 2]
    assert all(np.isfinite(v) for ln in lines for v in ln.values())
    assert {"D/latent_reg", "G/ref_lpips", "G/latent_flow", "G/lambda_ds"} <= set(lines[0])
    ckpts = StepCheckpoints(ck)
    assert ckpts.latest_step("nets") == 2
    for group in ("nets", "nets_ema", "optims", "camera"):
        assert (tmp / "ckpt" / f"000002_{group}.ckpt").exists(), group
    assert (tmp / "debug" / "Img_2.svg").exists()


def test_resume_starts_at_step_2_with_the_saved_state(trained, tmp_path, monkeypatch, capsys):
    """A second run resumes at the latest step: its state before the
    third iteration equals the saved one bit for bit."""
    from ppvision_tpu_torch.utils.checkpoint import StepCheckpoints

    tmp, ck0, _ = trained
    ck = str(tmp_path / "ckpt")
    shutil.copytree(ck0, ck)
    seen = []
    inner = cli.make_train_step

    def make(*args, **kw):
        step = inner(*args, **kw)

        def run(state, frozen, batch):
            seen.append((state.step, {k: {n: t.clone() for n, t in m.state_dict().items()}
                                      for k, m in state.nets.items()},
                         {k: {n: t.clone() for n, t in m.state_dict().items()} for k, m in state.ema.items()},
                         {k: copy.deepcopy(o.state_dict()) for k, o in state.optims.items()}))
            return step(state, frozen, batch)

        return run

    monkeypatch.setattr(cli, "make_train_step", make)
    state = cli.main(_train_args(tmp, 3, ck))
    assert "Resumed training from step 2" in capsys.readouterr().out
    assert [s[0] for s in seen] == [2] and state.step == 3
    ckpts = StepCheckpoints(ck)
    _, nets, ema, optims = seen[0]
    for group, got in (("nets", nets), ("nets_ema", ema)):
        saved = ckpts.load(2, group)
        for net, sd in got.items():
            assert all(torch.equal(sd[k], saved[net][k]) for k in sd), (group, net)
    saved = ckpts.load(2, "optims")
    for net, sd in optims.items():
        for i, st in sd["state"].items():
            for k, v in st.items():
                assert torch.equal(torch.as_tensor(v), torch.as_tensor(saved[net]["state"][i][k])), (net, i, k)


def test_first_iteration_equals_make_train_step_on_the_batcher(trained):
    """The CLI's step 1 (its seeds: init ``train.seed``, frozen nets 1,
    aux losses 2) equals ``train/gan.py::make_train_step`` on the first
    ``FaceBatcher`` batch of the same folders, bit for bit."""
    from ppvision_tpu_torch.data.face import FaceBatcher
    from ppvision_tpu_torch.train.gan import init_gan, make_train_step
    from ppvision_tpu_torch.train.pretrained import build_aux_losses, load_frozen_nets
    from ppvision_tpu_torch.utils.checkpoint import StepCheckpoints

    tmp, ck, _ = trained
    cfg = cli.config_from_args(cli.build_parser().parse_args(_train_args(tmp, 2, ck)))
    state = init_gan(cfg.train.seed, cfg, "cpu")
    frozen = load_frozen_nets(cfg, 1, "cpu")
    step = make_train_step(cfg, *build_aux_losses(cfg, 2, "cpu"))
    batcher = FaceBatcher(str(tmp / "train"), str(tmp / "ref"), img_size=IMG, batch_size=2,
                          latent_dim=cfg.model.latent_dim, seed=cfg.train.seed)
    try:
        step(state, frozen, next(batcher))
    finally:
        batcher.close()
    ckpts = StepCheckpoints(ck)
    for group, nets in (("nets", state.nets), ("nets_ema", state.ema)):
        saved = ckpts.load(1, group)
        for net, m in nets.items():
            assert all(torch.equal(v, saved[net][k]) for k, v in m.state_dict().items()), (group, net)


def test_sample_matches_the_jax_cli(tmp_path, monkeypatch):
    """``--mode sample`` of both CLIs from reference-format files: the
    camera and ``fan_priv`` in ``camera_ckpt`` ({'Camera', 'Decoder'}) and
    G, the mapping network and the style encoder in ``torch_nets_ckpt``,
    all from seeded port modules; one batch of 4 sources and 4 references
    at f32.  The arrays (not the PNGs) agree within 1e-3, the f32 bound of
    ``tests/test_torch_deid.py`` (measured 3.9e-4 on outputs up to 6.8)."""
    from ppvision_tpu import sample as jsample
    from ppvision_tpu.cli.main import config_from_args as jax_config
    from ppvision_tpu.cli.main import run_sample as jax_run_sample
    from ppvision_tpu_torch.deid import build_deid

    src, ref = _faces(tmp_path / "src", 2, n=2, hw=(IMG, IMG)), _faces(tmp_path / "ref", 3, n=2, hw=(IMG, IMG))
    args = ["--mode", "sample", *TINY, "--src_dir", src, "--ref_dir", ref, "--result_dir", "",
            "--val_batch_size", "4", "--camera_ckpt", str(tmp_path / "Model_wing.pth"),
            "--torch_nets_ckpt", str(tmp_path / "000010_nets_ema.ckpt"), "--device", "cpu"]
    cfg = cli.config_from_args(cli.build_parser().parse_args(args))
    seeded = build_deid(11, cfg, device="cpu")
    torch.save({"Camera": seeded.camera.state_dict(), "Decoder": seeded.fan.state_dict()}, cfg.paths.camera_ckpt)
    torch.save({k: getattr(seeded, k).state_dict() for k in ("generator", "mapping_network", "style_encoder")},
               cfg.paths.torch_nets_ckpt)
    got = cli.main(args)
    want = []
    inner = jsample.translate_using_reference

    def record(*a, **kw):
        want.append(inner(*a, **kw))
        return want[-1]

    monkeypatch.setattr(jsample, "translate_using_reference", record)
    # The JAX CLI builds its bundle with eager Flax inits (~40 s of this
    # test), and the files then replace every parameter those make, so the
    # inits are traced for their shapes only and filled with zeros (a
    # parameter left unreplaced would show as a mismatch below).
    import functools

    import flax.linen as nn

    init = nn.Module.init

    def shaped_init(self, *a, **kw):
        shapes = jax.eval_shape(functools.partial(init, self, **kw), *a)
        return jax.tree_util.tree_map(lambda t: jax.numpy.zeros(t.shape, t.dtype), shapes)

    monkeypatch.setattr(nn.Module, "init", shaped_init)
    jax_args = [a for a in args if a not in ("--device", "cpu")]
    from ppvision_tpu.cli.main import build_parser as jax_parser

    jax_run_sample(jax_config(jax_parser().parse_args(jax_args)), num_batches=1)
    assert len(got) == len(want) == 1
    assert got[0].shape == want[0].shape == (4, 4, IMG, IMG, 3)
    assert np.isfinite(got[0]).all()
    assert np.abs(got[0] - want[0]).max() <= 1e-3


def test_sample_video_writes_and_scores_a_sequence(tmp_path):
    """``--mode sample --video``: the sorted frames of ``src_dir`` anonymized
    with the first reference's style, the interpolation video over
    min(8, T, R) sources, and a finite RAFT flow-consistency score (RAFT
    on the windowed-correlation path, its pyramid cut to the 1/8 map)."""
    src, ref = _faces(tmp_path / "src", 4, n=2, hw=(IMG, IMG)), _faces(tmp_path / "ref", 5, n=2, hw=(IMG, IMG))
    out = cli.main(["--mode", "sample", "--video", *TINY, "--src_dir", src, "--ref_dir", ref,
                    "--result_dir", str(tmp_path / "out"), "--checkpoint_save_dir", str(tmp_path / "ck"),
                    "--device", "cpu"])
    assert out["fakes"].shape == (4, IMG, IMG, 3) and np.isfinite(out["fakes"]).all()
    assert out["video"].shape[1:] == (2 * IMG, IMG + 32 + 4 * IMG, 3) and np.isfinite(out["video"]).all()
    assert np.isfinite(out["score"])
