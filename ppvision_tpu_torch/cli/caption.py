"""Captioning CLI: preprocess / train / eval / heat.

Port of ``ppvision_tpu/cli/caption.py`` (reference
``Image_Caption/{create_input_files,train,eval/*,Camera/Camera_heating}.py``)
on one device: the JAX CLI's flags, plus ``--device`` (``cuda`` unless
``cpu`` is asked for) on the subcommands that compute.

Usage:
    python -m ppvision_tpu_torch.cli.caption preprocess --karpathy_json ... --image_folder ...
    python -m ppvision_tpu_torch.cli.caption train --data_folder ... --data_name coco_5_cap_per_img_5_min_word_freq
    python -m ppvision_tpu_torch.cli.caption eval  --data_folder ... --split TEST
    python -m ppvision_tpu_torch.cli.caption heat  --steps 5000 --img_dir ...

``train`` saves ``{epoch:06d}_caption_state.ckpt`` (the camera, encoder,
decoder and optimizer state_dicts and the step) into ``--out_dir`` when
an epoch's BLEU-4 passes the gate; ``eval`` and ``caption_image`` load
the latest.  ``heat`` saves the lens's state_dict (the reference
``OpticsZernike`` names) to ``--out``, which ``train --warmup_ckpt``
reads.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..data.caption import CaptionDataset, caption_batches
from ..metrics.eval_caption import evaluate_captions
from ..train.caption import make_caption_train_step


def _add_common(p):
    p.add_argument("--data_folder", default="data/caption")
    p.add_argument("--data_name", default="coco_5_cap_per_img_5_min_word_freq")
    p.add_argument("--out_dir", default="expr/caption")


def _add_device(p):
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def build_parser():
    p = argparse.ArgumentParser(description="privacy captioning on one GPU")
    sub = p.add_subparsers(dest="cmd", required=True)

    pp = sub.add_parser("preprocess")
    pp.add_argument("--dataset", default="coco")
    pp.add_argument("--karpathy_json", required=True)
    pp.add_argument("--image_folder", required=True)
    pp.add_argument("--captions_per_image", type=int, default=5)
    pp.add_argument("--min_word_freq", type=int, default=5)
    pp.add_argument("--output_folder", default="data/caption")
    pp.add_argument("--max_len", type=int, default=50)
    pp.add_argument(
        "--custom", action="store_true",
        help="lab-subset builder: first --train_limit readable train images "
        "-> TRAIN, rest -> VAL (reference create_input_files_custom)",
    )
    pp.add_argument("--train_limit", type=int, default=500)

    tr = sub.add_parser("train")
    _add_common(tr)
    tr.add_argument("--epochs", type=int, default=20)
    tr.add_argument("--batch_size", type=int, default=64)
    tr.add_argument("--camera_train", type=lambda s: s.lower() in ("1", "true"), default=True)
    tr.add_argument("--warmup_ckpt", default=None, help="camera warm-start (Model.pth equivalent)")
    tr.add_argument(
        "--encoder_ckpt", default=None,
        help="torchvision resnet101 state_dict for the encoder warm start "
        "(reference train.py:94-109)",
    )
    tr.add_argument(
        "--resume", action="store_true",
        help="resume from the latest caption_state checkpoint in out_dir",
    )
    _add_device(tr)

    ev = sub.add_parser("eval")
    _add_common(ev)
    ev.add_argument("--split", default="TEST", choices=["VAL", "TEST"])
    ev.add_argument("--beam_size", type=int, default=5)
    ev.add_argument("--camera_mode", default="lens", choices=["lens", "none", "lowres"])
    ev.add_argument("--max_images", type=int, default=None)
    _add_device(ev)

    ht = sub.add_parser("heat")
    ht.add_argument("--steps", type=int, default=5000)
    ht.add_argument("--img_dir", required=True)
    ht.add_argument("--out", default="expr/camera_warmup")
    _add_device(ht)
    return p


def _lens(device):
    """The full-size lens (``LensSpec()``) and its constants on ``device``."""
    from ..optics.lens import LensSpec, make_lens_constants

    spec = LensSpec()
    return spec, make_lens_constants(spec, device=device)


def _setup(cfg, vocab_size: int, device):
    """The lens, its constants and a caption train state with the encoder
    in bf16, as the JAX CLI builds them."""
    from ..train.caption import init_caption

    spec, consts = _lens(device)
    state = init_caption(0, cfg, vocab_size, spec, dtype=torch.bfloat16, device=device)
    return spec, consts, state


def _load_lens(camera, path: str) -> None:
    """A camera warm start: the reference ``OpticsZernike`` names, raw or
    under ``optics.`` (train.py:68-78)."""
    from ..train.pretrained import load_state_dict_file

    sd = load_state_dict_file(path)
    camera.load_state_dict({k: (sd[k] if k in sd else sd[f"optics.{k}"]).reshape(v.shape)
                            for k, v in camera.state_dict().items()})


def _batch_tensors(batch: dict, device) -> dict:
    return {k: torch.as_tensor(batch[k]).to(device) for k in ("images", "captions", "caption_lengths")}


def run_train(args):
    from ..config import CaptionConfig
    from ..utils.checkpoint import StepCheckpoints
    from ..utils.device import resolve_device
    from ..utils.logging import MetricWriter

    dev = resolve_device(args.device)
    cfg = CaptionConfig(batch_size=args.batch_size, epochs=args.epochs)
    with open(os.path.join(args.data_folder, f"WORDMAP_{args.data_name}.json")) as f:
        word_map = json.load(f)
    train_ds = CaptionDataset(args.data_folder, args.data_name, "TRAIN")
    val_ds = CaptionDataset(args.data_folder, args.data_name, "VAL")
    spec, consts, state = _setup(cfg, len(word_map) + 1, dev)
    if args.warmup_ckpt:
        _load_lens(state.camera, args.warmup_ckpt)
    if args.encoder_ckpt:
        from ..train.pretrained import load_state_dict_file

        # A torchvision ResNet-101's keys, its classifier ``fc`` left out.
        sd = load_state_dict_file(args.encoder_ckpt)
        state.encoder.load_state_dict({k: sd[k] for k in state.encoder.state_dict()})
    ckpts = StepCheckpoints(args.out_dir)
    start_epoch = 0
    if args.resume:
        latest = ckpts.latest_step("caption_state")
        if latest is not None:
            state.load_state_dict(ckpts.load(latest, "caption_state"))
            start_epoch = latest
            print(f"Resumed captioning training from epoch {latest}")
        else:
            print(f"--resume: no caption_state checkpoint in {args.out_dir}")
    step_fn = make_caption_train_step(cfg, spec, consts, camera_train=args.camera_train)
    writer = MetricWriter(args.out_dir, log_interval=50)
    gen = torch.Generator(device=dev).manual_seed(1)
    best_bleu4, step = 0.0, 0
    print(f"Start caption training on {dev}...")
    for epoch in range(start_epoch, cfg.epochs):
        for batch in caption_batches(train_ds, cfg.batch_size, shuffle=True, seed=epoch):
            metrics = step_fn(state, _batch_tensors(batch, dev), gen)
            step += 1
            writer.write(step, metrics)
        res = evaluate_captions(cfg, state.encoder, state.decoder, (state.camera, consts, spec), val_ds,
                                word_map, max_images=200)
        writer.write(step, {f"val_{k}": v for k, v in res.items()}, force=True)
        # BLEU-4 save gate (reference train.py:230-238).
        if res["bleu4"] >= cfg.bleu4_gate and res["bleu4"] > best_bleu4:
            best_bleu4 = res["bleu4"]
            ckpts.save(epoch + 1, "caption_state", state.state_dict())
    writer.close()
    return state


def run_eval(args):
    from ..config import CaptionConfig
    from ..utils.checkpoint import StepCheckpoints
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = CaptionConfig(beam_size=args.beam_size)
    with open(os.path.join(args.data_folder, f"WORDMAP_{args.data_name}.json")) as f:
        word_map = json.load(f)
    ds = CaptionDataset(args.data_folder, args.data_name, args.split)
    spec, consts, state = _setup(cfg, len(word_map) + 1, dev)
    ckpts = StepCheckpoints(args.out_dir)
    latest = ckpts.latest_step("caption_state")
    if latest is None:
        print(
            f"WARNING: no caption_state checkpoint in {args.out_dir} — "
            "evaluating RANDOM-INIT models; scores are meaningless.",
            file=sys.stderr,
        )
    else:
        state.load_state_dict(ckpts.load(latest, "caption_state"))
    res = evaluate_captions(
        cfg, state.encoder, state.decoder, (state.camera, consts, spec), ds, word_map,
        beam_size=args.beam_size, camera_mode=args.camera_mode, max_images=args.max_images,
        out_dir=args.out_dir,
    )
    for k, v in res.items():
        print(f"{k}: {v:.4f}")
    return res


def run_heat(args):
    """Camera warm-up: train the defocus alone to MINIMIZE SSIM(orig,
    sensor) + the PSF loss (reference Camera_heating.py:13-64), Adam at
    1e-2 on batches of 8 from ``--img_dir``."""
    from ..data.face import eval_batches
    from ..metrics.psnr_ssim import ssim
    from ..optics.lens import init_lens_params, lens_apply
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    spec, consts = _lens(dev)
    lens = init_lens_params(spec, dev)
    opt = torch.optim.Adam([lens.zernike_coeffs_train], lr=1e-2)
    it = 0
    while it < args.steps:
        for imgs in eval_batches(args.img_dir, spec.patch_size, 8):
            x = torch.from_numpy(imgs).to(dev)
            with torch.enable_grad():
                res = lens_apply(lens, consts, spec, x, mask_mode="3")
                loss = ssim(x, res.sensor) + res.psf_loss
                opt.zero_grad(set_to_none=True)
                loss.backward()
            opt.step()
            it += 1
            if it % 100 == 0:
                print(f"heat step {it}: ssim+psf {float(loss):.4f} defocus {float(lens.defocus.detach()):.3f}")
            if it >= args.steps:
                break
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save(lens.state_dict(), args.out)
    return lens


def main(argv=None):
    args = build_parser().parse_args(argv)
    np.random.seed(0)
    if args.cmd == "preprocess":
        if args.custom:
            from ..data.caption import create_input_files_custom

            create_input_files_custom(
                args.dataset, args.karpathy_json, args.image_folder,
                args.captions_per_image, args.min_word_freq, args.output_folder,
                args.max_len, train_limit=args.train_limit,
            )
        else:
            from ..data.caption import create_input_files

            create_input_files(
                args.dataset, args.karpathy_json, args.image_folder,
                args.captions_per_image, args.min_word_freq, args.output_folder,
                args.max_len,
            )
        return None
    if args.cmd == "train":
        return run_train(args)
    if args.cmd == "eval":
        return run_eval(args)
    return run_heat(args)


if __name__ == "__main__":
    main()
