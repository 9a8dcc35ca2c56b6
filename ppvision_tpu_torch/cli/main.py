"""Face-DeId CLI: train / sample / eval / align (reference ``main.py`` modes).

Port of ``ppvision_tpu/cli/main.py``.  Usage:

    python -m ppvision_tpu_torch.cli.main --mode train --train_img_dir ... --ref_dir ...
    python -m ppvision_tpu_torch.cli.main --mode sample --src_dir ... --ref_dir ... [--video]
    python -m ppvision_tpu_torch.cli.main --mode eval --val_img_dir ... [--allow_random_metrics]
    python -m ppvision_tpu_torch.cli.main --mode align --inp_dir ... --out_dir ...

The flags are the JAX CLI's (the reference argparse surface,
main.py:86-198), with its names and defaults from the typed config
tree, plus ``--device`` (``cuda`` by default; ``cpu`` runs the plain
PyTorch path).  Training runs on one device: data parallelism is not
ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from ..data.face import FaceBatcher, eval_batches
from ..deid import build_deid, deid_from_reference
from ..train.gan import init_gan, make_train_step
from ..train.pretrained import (
    build_aux_losses,
    load_frozen_nets,
    load_state_dict_file,
    restore_deid_params,
    warm_start_state,
    warn_random_init,
)
from ..utils.checkpoint import StepCheckpoints, restore_train_state, save_train_state
from ..utils.device import resolve_device
from ..utils.logging import MetricWriter

__all__ = [
    "build_parser",
    "config_from_args",
    "main",
    "run_align",
    "run_eval",
    "run_sample",
    "run_train",
    "run_video",
    "video_from_arrays",
]


def build_parser() -> argparse.ArgumentParser:
    from ..config import FaceDeIdConfig

    cfg = FaceDeIdConfig()
    p = argparse.ArgumentParser(description="Face-DeId on PyTorch (CUDA)")
    p.add_argument("--mode", required=True, choices=["train", "sample", "eval", "align"])
    p.add_argument("--inp_dir", default="", help="input dir for --mode align")
    p.add_argument("--out_dir", default="", help="output dir for --mode align")
    for section in ("model", "loss", "train", "camera", "paths"):
        sub = getattr(cfg, section)
        for f in dataclasses.fields(sub):
            flag = f"--{f.name}"
            default = getattr(sub, f.name)
            if isinstance(default, bool):
                p.add_argument(flag, type=lambda s: s.lower() in ("1", "true"), default=default)
            elif isinstance(default, (int, float, str)):
                p.add_argument(flag, type=type(default), default=default)
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--num_sample_batches", type=int, default=1)
    p.add_argument(
        "--video", action="store_true",
        help="with --mode sample: treat src_dir as a frame sequence; "
        "write de-id + interpolation videos and a flow-consistency score",
    )
    p.add_argument(
        "--allow_random_metrics", action="store_true",
        help="let --mode eval run with random-weight metric nets "
        "(relative comparisons only; published numbers need converted ckpts)",
    )
    p.add_argument(
        "--aligned_face_id", action="store_true",
        help="with --mode eval: insightface-comparable face-ID cosines "
        "(FAN landmarks -> ArcFace-template warp; needs wing ckpt)",
    )
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p


def config_from_args(args):
    from ..config import CameraConfig, FaceDeIdConfig, LossConfig, ModelConfig, PathsConfig, TrainConfig

    def fill(cls):
        return cls(**{f.name: getattr(args, f.name) for f in dataclasses.fields(cls) if hasattr(args, f.name)})

    return FaceDeIdConfig(
        model=fill(ModelConfig), loss=fill(LossConfig), train=fill(TrainConfig),
        camera=fill(CameraConfig), paths=fill(PathsConfig),
    )


def run_train(cfg, use_wandb: bool = False, device="cuda"):
    """The reference Solver's training loop on one device: resume from
    ``resume_iter`` (or the latest saved step) or warm start, then
    ``total_iters`` iterations on ``FaceBatcher`` batches with the metric
    writer, the debug grid every ``debug_every`` and the ``nets``,
    ``nets_ema``, ``optims`` and ``camera`` groups every ``save_every``
    (solver.py:92-248).  Returns the train state."""
    dev = resolve_device(device)
    state = init_gan(cfg.train.seed, cfg, dev)
    # Pretrained camera + wing FAN + fan_priv decoder (solver.py:44-48, 99).
    frozen = load_frozen_nets(cfg, 1, dev)
    ckpts = StepCheckpoints(cfg.paths.checkpoint_save_dir)
    # Resume (solver.py:92-134): the nets, EMA nets and optimizers at
    # resume_iter, or at the latest saved step when it is 0; lambda_ds
    # follows from the restored step.
    start = cfg.train.resume_iter or (ckpts.latest_step("nets") or 0)
    if start and os.path.exists(ckpts.path(start, "nets")):
        restore_train_state(ckpts, state, start)
        print(f"Resumed training from step {start}")
    else:
        if start:
            print(f"No checkpoint at step {start} in {ckpts.root}; trying warm start")
            start = 0
        warm_start_state(state, cfg)
    # Full paper loss: LPIPS x2000 + RAFT flow x10 (solver.py:161-184).
    lpips_fn, flow_fn = build_aux_losses(cfg, 2, dev)
    step_fn = make_train_step(cfg, lpips_fn=lpips_fn, flow_fn=flow_fn)
    writer = MetricWriter(cfg.paths.checkpoint_save_dir, use_wandb, cfg.train.print_every)
    batcher = FaceBatcher(
        cfg.paths.train_img_dir, cfg.paths.ref_dir, img_size=cfg.model.img_size,
        batch_size=cfg.train.batch_size, latent_dim=cfg.model.latent_dim,
        crop_prob=cfg.train.randcrop_prob, seed=cfg.train.seed,
    )
    debug_fwd = None
    print(f"Start training on {dev}...")
    try:
        for i in range(start, cfg.train.total_iters):
            batch = next(batcher)
            metrics = step_fn(state, frozen, batch)
            writer.write(i + 1, metrics)
            if cfg.train.debug_every and (i + 1) % cfg.train.debug_every == 0:
                # The reference's 10-panel grid (solver.py:216-248).
                from ..utils.debug import make_debug_forward, save_debug_grid

                if debug_fwd is None:
                    debug_fwd = make_debug_forward(cfg)
                images, heats = debug_fwd(state.nets, frozen, batch)
                save_debug_grid(images, heats, os.path.join(cfg.paths.debug_dir, f"Img_{i + 1}.svg"))
            if (i + 1) % cfg.train.save_every == 0:
                save_train_state(ckpts, state)
                ckpts.save(i + 1, "camera", frozen.camera.state_dict())
    finally:
        batcher.close()
        writer.close()
    return state


def run_sample(cfg, num_batches: int = 1, video: bool = False, device="cuda"):
    """``--mode sample``: the de-id bundle with the restored weights
    (``restore_deid_params``), then reference-style translations of the
    first ``num_batches`` source batches, written under ``result_dir``
    where it is set; returns each batch's (R, B, H, W, 3) outputs, or
    with ``video`` what :func:`run_video` returns."""
    from ..sample import translate_using_reference

    bundle = restore_deid_params(build_deid(cfg.train.seed, cfg, device), cfg)
    if video:
        return run_video(cfg, bundle)
    srcs = eval_batches(cfg.paths.src_dir, cfg.model.img_size, cfg.train.val_batch_size)
    refs = eval_batches(cfg.paths.ref_dir, cfg.model.img_size, cfg.train.val_batch_size)
    outs = []
    for i, (src, ref) in enumerate(zip(srcs, refs)):
        if i >= num_batches:
            break
        print(f"Working on batch {i}...")
        y_ref = torch.zeros((ref.shape[0],), dtype=torch.long)
        outs.append(translate_using_reference(
            bundle, torch.from_numpy(src), torch.from_numpy(ref), y_ref, out_dir=cfg.paths.result_dir, tag=i,
        ))
    return outs


def video_from_arrays(bundle, srcs: torch.Tensor, refs: torch.Tensor, out_dir: str, raft=None,
                      n_interp: int | None = None) -> dict:
    """Video de-id of (T, H, W, 3) frames ``srcs`` in [0, 1]: each frame
    anonymized with the first reference's style, the style-interpolation
    video over the first ``n_interp`` sources (``min(8, T, R)`` by
    default) and references, and, with ``raft`` and T >= 2, the RAFT
    temporal flow-consistency score at 12 iterations (reference
    core/utils.py:259-425 + loss_RAFT).  Writes ``video_deid.mp4`` and ``video_ref.mp4`` into
    ``out_dir`` where ffmpeg exists.  Returns the de-id frames, whether
    the first video was written, the interpolation frames and the score."""
    from ..metrics.temporal import flow_consistency
    from ..sample import video_ref, write_video

    t = srcs.shape[0]
    ref0 = refs[:1].expand(t, -1, -1, -1)
    fakes = deid_from_reference(bundle, srcs, ref0, torch.zeros(t, dtype=torch.long)).cpu().numpy()
    wrote = write_video(fakes, os.path.join(out_dir, "video_deid.mp4"))
    n = min(8, t, refs.shape[0]) if n_interp is None else n_interp
    r = refs[: max(n, 2)]
    video = video_ref(bundle, srcs[:n], r, torch.zeros(r.shape[0], dtype=torch.long),
                      os.path.join(out_dir, "video_ref.mp4"))
    score = flow_consistency(raft, srcs, fakes) if raft is not None and t >= 2 else None
    return dict(fakes=fakes, wrote=wrote, video=video, score=score)


def run_video(cfg, bundle) -> dict:
    """Video de-id (BASELINE config 5) of ``src_dir``'s sorted frames with
    the references of ``ref_dir``: :func:`video_from_arrays` with
    full-size RAFT on the windowed-correlation kernel
    (``alternate_corr=True``), its pyramid as deep as the 1/8-resolution
    map allows, from ``raft_path`` where it exists."""
    from ..models.raft import build_raft

    out_dir = cfg.paths.result_dir
    os.makedirs(out_dir, exist_ok=True)
    size, vb = cfg.model.img_size, cfg.train.val_batch_size
    srcs = torch.from_numpy(np.concatenate(list(eval_batches(cfg.paths.src_dir, size, vb))))
    refs = torch.from_numpy(np.concatenate(list(eval_batches(cfg.paths.ref_dir, size, vb))))
    raft = None
    if srcs.shape[0] >= 2:
        fmap = max(size // 8, 1)
        corr_levels = max(1, min(4, int(np.log2(fmap)) + 1))
        raft = build_raft(0, bundle.device, corr_levels=corr_levels, alternate_corr=True)
        if os.path.exists(cfg.paths.raft_path):
            raft.load_state_dict(load_state_dict_file(cfg.paths.raft_path))
        else:
            warn_random_init("RAFT (raft-things.pth)", cfg.paths.raft_path)
    out = video_from_arrays(bundle, srcs, refs, out_dir, raft)
    print(f"Wrote de-id sequence video to {os.path.join(out_dir, 'video_deid.mp4')}: {out['wrote']}")
    if out["score"] is not None:
        print(f"flow_consistency_epe: {out['score']:.4f}")
    return out


def _wing_fan(cfg, dtype, device) -> "torch.nn.Module":
    """The clean-image FAN from ``wing_path`` (state_dict names), in
    ``dtype``; its seeded init with a loud warning where the file is
    absent."""
    from ..models.fan import FAN
    from ..models.stargan import init_params_

    fan = init_params_(FAN(dtype=dtype), 0, gain=1.0)
    if os.path.exists(cfg.paths.wing_path):
        fan.load_state_dict(load_state_dict_file(cfg.paths.wing_path))
    else:
        warn_random_init("FAN (wing.ckpt)", cfg.paths.wing_path)
    return fan.to(resolve_device(device)).eval().requires_grad_(False)


def run_eval(cfg, allow_random_metrics: bool = False, aligned_face_id: bool = False, device="cuda") -> dict:
    """``--mode eval``: the de-id bundle with the restored weights
    (``restore_deid_params``), the pretrained metric nets that exist, and
    ``calculate_metrics`` in latent and reference mode on
    ``val_img_dir``, written under ``eval_dir``.  Returns ``{mode:
    metrics}``."""
    from ..metrics.eval_gan import calculate_metrics, load_metric_nets

    if aligned_face_id and not os.path.exists(cfg.paths.wing_path):
        # Checked before the bundle is built, so it fails at once.
        raise FileNotFoundError(
            f"--aligned_face_id needs the wing FAN checkpoint at {cfg.paths.wing_path} (clean-image landmarks)"
        )
    bundle = restore_deid_params(build_deid(cfg.train.seed, cfg, device), cfg)
    metric_nets = load_metric_nets(cfg.paths, bundle.device)
    align_fan = _wing_fan(cfg, bundle.compute_dtype, bundle.device) if aligned_face_id else None
    out = {}
    for mode in ("latent", "reference"):
        out[mode] = calculate_metrics(
            bundle, cfg.paths.val_img_dir, mode=mode, num_outs=cfg.train.num_outs_per_domain,
            out_dir=cfg.paths.eval_dir, allow_random_metrics=allow_random_metrics, align_fan=align_fan, **metric_nets,
        )
        for k, v in out[mode].items():
            print(f"{k}: {v:.4f}")
    return out


def run_align(cfg, inp_dir: str, out_dir: str, device="cuda") -> None:
    """``--mode align``: each image of ``inp_dir`` resized to ``img_size``,
    aligned to the CelebA mean landmarks (``lm_path``, or every landmark at
    the centre where it is absent) by the wing FAN, written under the same
    name to ``out_dir`` (reference align_faces, wing.py:446-467)."""
    from PIL import Image

    from ..models.align import FaceAligner

    fan = _wing_fan(cfg, None, device)
    if os.path.exists(cfg.paths.lm_path):
        mean_lm = np.load(cfg.paths.lm_path)["mean"]
    else:
        mean_lm = np.tile([[128.0, 128.0]], (98, 1))
    aligner = FaceAligner(fan, mean_lm, cfg.model.img_size)
    os.makedirs(out_dir, exist_ok=True)
    for fname in sorted(os.listdir(inp_dir)):
        img = Image.open(os.path.join(inp_dir, fname)).convert("RGB")
        img = img.resize((cfg.model.img_size,) * 2, Image.BILINEAR)
        x = np.asarray(img, np.float32)[None] / 255.0 * 2.0 - 1.0
        aligned = aligner.align(x)[0]
        out = np.clip((aligned * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)
        Image.fromarray(out).save(os.path.join(out_dir, fname))
        print(f"Saved the aligned image to {fname}...")


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    np.random.seed(cfg.train.seed)
    if args.mode == "train":
        return run_train(cfg, args.use_wandb, args.device)
    if args.mode == "sample":
        return run_sample(cfg, args.num_sample_batches, video=args.video, device=args.device)
    if args.mode == "align":
        return run_align(cfg, args.inp_dir, args.out_dir, device=args.device)
    return run_eval(cfg, args.allow_random_metrics, args.aligned_face_id, device=args.device)


if __name__ == "__main__":
    main()
