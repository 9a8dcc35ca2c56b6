"""The caption trainer on two gloo ranks against one process, and the
two CLIs and the dry run on two ranks.

- Two caption steps, B = 4, two a rank, with captions of unequal lengths
  across the ranks (10, 9 | 4, 3), dropout 0.5 and the lens's height
  noise, with and without ``remat``, against one process on the whole
  batch at f64 (the port's single-process step is held to the JAX
  package's by ``tests/test_torch_train_caption.py``): the metrics, and
  every parameter and BN statistic after them, within ``REL`` (1e-10)
  of max(1, |value|); the ranks end with the same state bit for bit.
- ``cli/main.py --mode train`` and ``cli/caption.py train`` on two ranks
  over tiny folders write exactly one checkpoint, from the primary, as
  ``tests/test_mesh.py`` checks of the JAX CLIs.
- ``python -m ppvision_tpu_torch.parallel.dryrun 2 --device cpu``.
- The BN of a mesh of more than one rank (``_SyncedBatchNorm``) in one
  process: at f64 it is ``F.batch_norm``'s training BN within 1e-12; in
  f32 a ResNet-101 trunk's gradient with it is no further from the f64
  gradient than with ``F.batch_norm``, times 1.5.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import torch_ranks
from .test_torch_sharded_train import REL, _close_params
from .torch_parity import two_threads  # noqa: F401

CAPTION_LENGTHS = [10, 9, 4, 3]  # rank 0's captions are the long ones


@pytest.fixture(scope="module")
def caption_single():
    batches = torch_ranks.caption_batches(2, len(CAPTION_LENGTHS), CAPTION_LENGTHS)
    state, step = torch_ranks.build_caption(torch_ranks.caption_cfg(batch_size=len(CAPTION_LENGTHS)))
    gen = torch.Generator().manual_seed(0)
    metrics = [{k: float(v) for k, v in step(state, b, gen).items()} for b in batches]
    return batches, metrics, torch_ranks.caption_snapshot(state)


@pytest.mark.parametrize("remat", [False, True])
def test_sharded_caption_steps_match_one_process_at_f64(caption_single, tmp_path, remat):
    batches, want, params = caption_single
    ranks = torch_ranks.launch("caption_step", 2, tmp_path, batches=batches, remat=remat)
    for r in ranks:
        for got, w in zip(r["metrics"], want):
            assert got.keys() == w.keys()
            for k in w:
                assert abs(got[k] - w[k]) <= REL * max(1.0, abs(w[k])), (k, got[k], w[k])
        _close_params(r["params"], params)
    assert all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k]) for k in params)
    assert torch_ranks.CAPTION_CFG["dropout"] > 0
    # The BN statistics moved.
    assert not torch.equal(params["encoder.layer4.0.bn1.running_var"], torch.ones_like(params[
        "encoder.layer4.0.bn1.running_var"]))


def _faces(root, seed: int, n: int = 3, hw=(40, 36)) -> str:
    from PIL import Image

    rng = np.random.default_rng(seed)
    for cls in ("female", "male"):
        (root / cls).mkdir(parents=True)
        for i in range(n):
            base = rng.integers(0, 256, (hw[0] // 4, hw[1] // 4, 3), dtype=np.uint8)
            Image.fromarray(base).resize((hw[1], hw[0]), Image.BILINEAR).save(root / cls / f"{i:03d}.png")
    return str(root)


def test_gan_cli_on_two_ranks_writes_one_checkpoint(tmp_path):
    """``--mode train`` for one iteration of a global batch of 4, saving
    every step: the primary writes the step's four groups and one metrics
    line, the other rank nothing; the ranks end with the same nets."""
    _faces(tmp_path / "train", 0)
    _faces(tmp_path / "ref", 1)
    ck = tmp_path / "ckpt"
    argv = ["--mode", "train", "--img_size", "32", "--fan_input_size", "64", "--max_conv_dim", "32",
            "--style_dim", "8", "--compute_dtype", "float32", "--zernike_terms", "16", "--n", "32",
            "--batch_size", "4", "--flow_iters", "1", "--total_iters", "1", "--save_every", "1",
            "--print_every", "1", "--debug_every", "0", "--train_img_dir", str(tmp_path / "train"),
            "--ref_dir", str(tmp_path / "ref"), "--checkpoint_save_dir", str(ck),
            "--checkpoint_dir", str(tmp_path / "none"), "--device", "cpu"]
    lead, follow = torch_ranks.launch("gan_cli", 2, tmp_path, argv=argv)
    assert lead["saves"] == [(1, "nets"), (1, "nets_ema"), (1, "optims"), (1, "camera")]
    assert follow["saves"] == []
    assert lead["step"] == follow["step"] == 1
    assert sorted(p.name for p in ck.iterdir()) == ["000001_camera.ckpt", "000001_nets.ckpt",
                                                    "000001_nets_ema.ckpt", "000001_optims.ckpt", "metrics.jsonl"]
    assert len((ck / "metrics.jsonl").read_text().splitlines()) == 1
    assert all(torch.equal(lead["params"][k], follow["params"][k]) for k in lead["params"])


def test_caption_cli_on_two_ranks_writes_one_checkpoint(tmp_path):
    """``train`` for one epoch of a global batch of 2 (one a rank) at a tiny
    configuration, its eval made to pass the BLEU-4 gate: the primary
    evaluates and writes the one checkpoint, the other rank neither."""
    from ppvision_tpu_torch.cli import caption as cli

    from .test_torch_caption_cli import NAME, TINY_CFG, TINY_LENS, _karpathy

    js, imgs = _karpathy(tmp_path)
    cli.main(["preprocess", "--karpathy_json", js, "--image_folder", imgs, "--captions_per_image", "2",
              "--min_word_freq", "0", "--max_len", "8", "--output_folder", str(tmp_path / "data")])
    out = tmp_path / "out"
    argv = ["train", "--data_folder", str(tmp_path / "data"), "--data_name", NAME, "--out_dir", str(out),
            "--device", "cpu", "--epochs", "1", "--batch_size", "2"]
    lead, follow = torch_ranks.launch("caption_cli", 2, tmp_path, argv=argv, cfg=TINY_CFG, lens_spec=TINY_LENS)
    # 5 TRAIN images x 2 captions = 10 items: 5 global batches of 2.
    assert lead["step"] == follow["step"] == 5
    assert lead["evals"] == 1 and follow["evals"] == 0
    assert lead["saves"] == [(1, "caption_state")] and follow["saves"] == []
    assert sorted(p.name for p in out.iterdir()) == ["000001_caption_state.ckpt", "metrics.jsonl"]
    steps = [json.loads(s)["step"] for s in (out / "metrics.jsonl").read_text().splitlines()]
    assert steps == sorted(steps) and len(steps) == len(set(steps))
    assert all(torch.equal(lead["params"][k], follow["params"][k]) for k in lead["params"])


def test_dryrun_runs_both_trainers_on_two_cpu_ranks():
    env = dict(os.environ, PYTHONPATH=torch_ranks.ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "ppvision_tpu_torch.parallel.dryrun", "2", "--device", "cpu"],
                         cwd=torch_ranks.ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "dryrun OK on 2 ranks (cpu): gan + caption" in out.stdout


def _synced_bn(mesh):
    from ppvision_tpu_torch.models.resnet import _SyncedBatchNorm

    def forward(self, x):
        return _SyncedBatchNorm.apply(x, self.weight, self.bias, self.eps, mesh)[0]

    return forward


def test_synced_batchnorm_against_f_batch_norm(monkeypatch):
    """The synced BN's own arithmetic, on a one-process group: at f64 a
    channels-last BN's output and its three gradients equal
    ``F.batch_norm``'s within 1e-12.  In f32 the trunk's gradient (layers
    2-4, 64^2 images, B = 2) is rounding amplified through 33 BNs: with
    either BN it is several percent off the f64 one; the synced BN's
    error may not exceed ``F.batch_norm``'s by more than half."""
    from ppvision_tpu_torch.models import resnet
    from ppvision_tpu_torch.parallel.mesh import make_mesh

    assert not dist.is_initialized()
    mesh = make_mesh("cpu")
    try:
        rng = np.random.default_rng(3)
        x = torch.from_numpy(rng.standard_normal((4, 6, 5, 5)) * 3 + 2).contiguous(memory_format=torch.channels_last)
        w, b = (torch.from_numpy(rng.standard_normal(6)) for _ in range(2))
        dy = torch.from_numpy(rng.standard_normal((4, 6, 5, 5)))
        outs = []
        for synced in (True, False):
            xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
            if synced:
                bn = torch.nn.Module()
                bn.weight, bn.bias, bn.eps = ws, bs, 1e-5
                y = _synced_bn(mesh)(bn, xs)
            else:
                y = F.batch_norm(xs, None, None, ws, bs, True, 0.0, 1e-5)
            outs.append([y, *torch.autograd.grad((y * dy).sum(), (xs, ws, bs))])
        for got, want in zip(*outs):
            torch.testing.assert_close(got, want, rtol=0, atol=1e-12)

        enc = resnet.init_encoder_(resnet.CaptionEncoder(4), 0).train()
        images = torch.from_numpy(rng.random((2, 64, 64, 3)))
        weight = torch.from_numpy(rng.standard_normal((2, 4, 4, 2048)))

        def trunk_grad(dtype, synced):
            e = resnet.init_encoder_(resnet.CaptionEncoder(4), 0).train().to(dtype)
            e.load_state_dict(enc.state_dict())
            with monkeypatch.context() as mp:
                if synced:
                    mp.setattr(resnet.BatchNorm, "forward", _synced_bn(mesh))
                out = e(images.to(dtype))
            params = [p for n, p in e.named_parameters() if n.startswith(("layer2", "layer3", "layer4"))]
            return torch.cat([g.double().flatten() for g in torch.autograd.grad((out * weight.to(dtype)).sum(),
                                                                                 params)])

        exact = trunk_grad(torch.float64, False)
        err = {s: float((trunk_grad(torch.float32, s) - exact).norm() / exact.norm()) for s in (False, True)}
        assert err[True] <= 1.5 * err[False], err
    finally:
        dist.destroy_process_group()
