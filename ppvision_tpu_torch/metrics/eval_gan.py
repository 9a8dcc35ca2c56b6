"""Face-DeId evaluation: LPIPS diversity, identity leakage and FID over
domain pairs.

Port of ``ppvision_tpu/metrics/eval_gan.py`` (the reference's
``calculate_metrics`` / ``calculate_fid_for_all_tasks``,
``Face-DeId/metrics/eval.py:16-148``): for every (source -> target)
domain pair, the camera's privacy images, the heatmaps and ``num_outs``
anonymized outputs a source (latent or reference styles, drawn from the
same ``np.random.default_rng(seed)`` stream in the same order as the JAX
package); the mean pairwise LPIPS among a source's outputs; the mean
face-ID cosine between each source and its outputs; the PNGs where asked;
then FID between the target domain's real images and each task's
outputs, and pooled per target domain where it has several sources.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..data import face
from ..deid import DeIdBundle, _nchw, deid_from_styles
from ..models.stargan import init_params_
from .face_id import IResNet, make_aligned_embed_fn, make_embed_fn
from .fid import InceptionV3, collect_activations, fid_from_activations
from .lpips import LPIPS, lpips_state_dict_from_reference, make_pairwise_lpips_fn

__all__ = ["calculate_metrics", "load_metric_nets"]


def _domains(root: str) -> list[str]:
    return sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))


def _ready(module: torch.nn.Module, device) -> torch.nn.Module:
    return module.to(device).eval().requires_grad_(False)


def load_metric_nets(paths, device="cuda") -> dict[str, torch.nn.Module]:
    """The metric nets whose pretrained files exist under a
    ``PathsConfig``: ``lpips`` (``alexnet_path`` and ``lpips_path``),
    ``inception`` (``inception_path``, torchvision names) and ``arcface``
    (``arcface_path``, insightface ``iresnet50``), each loaded by its
    state_dict names; a missing one is absent."""
    from ..train.pretrained import load_state_dict_file

    out: dict[str, torch.nn.Module] = {}
    if os.path.exists(paths.lpips_path) and os.path.exists(paths.alexnet_path):
        out["lpips"] = LPIPS()
        out["lpips"].load_state_dict(lpips_state_dict_from_reference(
            load_state_dict_file(paths.alexnet_path), load_state_dict_file(paths.lpips_path)))
    if os.path.exists(paths.inception_path):
        out["inception"] = InceptionV3()
        out["inception"].load_state_dict(load_state_dict_file(paths.inception_path))
    if os.path.exists(paths.arcface_path):
        out["arcface"] = IResNet()
        out["arcface"].load_state_dict(load_state_dict_file(paths.arcface_path))
    return {k: _ready(m, device) for k, m in out.items()}


@torch.no_grad()
def _generate(bundle: DeIdBundle, mode: str, x_src, y, rng: np.random.Generator, trg_files, num_outs: int):
    """(R, B, H, W, 3) outputs for a source batch: R latent codes a source
    (``standard_normal((R, B, latent_dim))``) through the mapping network,
    or R reference faces a source (``rng.choice(trg_files, R * B)``)
    through the style encoder; then :func:`deid.deid_from_styles`."""
    b, size = x_src.shape[0], bundle.cfg.model.img_size
    yy = y.repeat(num_outs)
    if mode == "latent":
        zs = rng.standard_normal((num_outs, b, bundle.cfg.model.latent_dim)).astype(np.float32)
        s = bundle.mapping_network(torch.from_numpy(zs).to(bundle.device).reshape(num_outs * b, -1), yy)
    else:
        ref_paths = rng.choice(trg_files, num_outs * b)
        xr = np.stack([face._resize(face._load_rgb(p), (size, size)).astype(np.float32) / 255.0 for p in ref_paths])
        s = bundle.style_encoder(_nchw(torch.from_numpy(xr).to(bundle.device)), yy)
    return deid_from_styles(bundle, x_src, s.reshape(num_outs, b, -1))


@torch.no_grad()
def _id_cosines(embed, x_src, fakes) -> torch.Tensor:
    """(R,) mean cosine(source, output) of each output."""
    r, b = fakes.shape[:2]
    es = embed(x_src)
    ef = embed(fakes.reshape(r * b, *fakes.shape[2:])).reshape(r, b, -1)
    return torch.mean(torch.sum(es[None] * ef, dim=-1), dim=1)


@torch.no_grad()
def _fake_activations(inception: InceptionV3, fakes) -> np.ndarray:
    """Inception activations of (R, B, H, W, 3) outputs, one (B, ...)
    group after another: a half-pixel bilinear resize to 299^2 (what
    ``jax.image.resize`` gives when it grows), then the ImageNet
    normalization."""
    mean = torch.from_numpy(face.IMAGENET_MEAN).to(fakes.device)
    std = torch.from_numpy(face.IMAGENET_STD).to(fakes.device)

    def prep(f):
        f = F.interpolate(f.permute(0, 3, 1, 2), size=(299, 299), mode="bilinear", align_corners=False)
        return (f.permute(0, 2, 3, 1) - mean) / std

    return collect_activations(inception, (prep(f) for f in fakes))


def _write_pngs(out_dir: str, task: str, outs: np.ndarray, base: int) -> None:
    """All R outputs of each source, the reference's file-per-output layout
    ``%.4i_%.2i.png`` (source, style), both 1-based (eval.py:85-93)."""
    from PIL import Image

    os.makedirs(os.path.join(out_dir, task), exist_ok=True)
    arr = np.clip(outs * 255, 0, 255).astype(np.uint8)
    for j in range(arr.shape[0]):
        for k in range(arr.shape[1]):
            Image.fromarray(arr[j, k]).save(os.path.join(out_dir, task, "%.4i_%.2i.png" % (base + k + 1, j + 1)))


def calculate_metrics(
    bundle: DeIdBundle,
    val_root: str,
    mode: str = "latent",
    num_outs: int = 10,
    batch_size: int = 8,
    lpips: LPIPS | None = None,
    inception: InceptionV3 | None = None,
    arcface: IResNet | None = None,
    allow_random_metrics: bool = False,
    out_dir: str | None = None,
    step: int = 0,
    seed: int = 0,
    max_images: int | None = None,
    align_fan=None,
) -> dict[str, float]:
    """``LPIPS_{mode}/{src}2{trg}``, ``FaceIDcos_{mode}/...`` and
    ``FID_{mode}/...`` for every task, and ``FID_domain_{mode}/{trg}``
    for a target domain with several sources; written to
    ``metrics_{mode}_{step}.json`` with the PNGs where ``out_dir`` is set.

    The metric nets come from pretrained files (:func:`load_metric_nets`).
    Without them the eval refuses to make numbers that look published,
    unless ``allow_random_metrics``: then seeded random nets stand in
    (relative comparisons only) and a loud warning says so.

    ``align_fan`` (a clean-image FAN, e.g. the wing checkpoint's) makes
    the face-ID embed the insightface-comparable one (landmarks ->
    ArcFace-template warp -> embed); the default whole-frame embed is
    self-consistent for parity."""
    if mode not in ("latent", "reference"):
        raise ValueError(f"mode must be 'latent' or 'reference', not {mode!r}")
    missing = [n for n, m in (("LPIPS", lpips), ("InceptionV3/FID", inception), ("ArcFace/face-ID", arcface)) if m is None]
    if missing and not allow_random_metrics:
        raise RuntimeError(
            f"metric nets without pretrained weights: {', '.join(missing)}. "
            "Pretrained checkpoints are required to reproduce published "
            "numbers (see load_metric_nets); pass allow_random_metrics=True "
            "(CLI: --allow_random_metrics) for relative-only numbers from "
            "random nets."
        )
    if missing:
        print(
            f"WARNING: random-weight metric nets: {', '.join(missing)} — "
            "values are NOT comparable to published numbers.",
            file=sys.stderr,
        )
    dev = bundle.device
    if lpips is None:
        lpips = LPIPS()
        init_params_(lpips.alexnet, seed, gain=1.0)
    if inception is None:
        inception = init_params_(InceptionV3(), seed + 1, gain=1.0)
    if arcface is None:
        arcface = init_params_(IResNet(), seed + 2, gain=1.0)
    lpips, inception, arcface = (_ready(m, dev) for m in (lpips, inception, arcface))
    cfg = bundle.cfg
    img_size = cfg.model.img_size
    domains = _domains(val_root)
    lpips_pairs = make_pairwise_lpips_fn(lpips, num_outs)
    if align_fan is not None:
        embed = make_aligned_embed_fn(arcface, align_fan, input_size=cfg.model.fan_input_size)
    else:
        embed = make_embed_fn(arcface)

    rng = np.random.default_rng(seed)
    results: dict[str, float] = {}
    fake_acts: dict[tuple[str, str], list[np.ndarray]] = {}
    for trg_idx, trg in enumerate(domains):
        for src in domains:
            if src == trg:
                continue
            task = f"{src}2{trg}"
            lpips_vals, id_vals = [], []
            trg_files = face.list_images(os.path.join(val_root, trg))
            n_seen = 0
            for batch in face.eval_batches(os.path.join(val_root, src), img_size, batch_size):
                if max_images is not None and n_seen >= max_images:
                    break
                n_seen += batch.shape[0]
                x_src = torch.from_numpy(batch).to(dev)
                y = torch.full((batch.shape[0],), trg_idx, dtype=torch.long, device=dev)
                fakes = _generate(bundle, mode, x_src, y, rng, trg_files, num_outs)
                lpips_vals.extend(lpips_pairs(fakes).tolist())
                id_vals.extend(_id_cosines(embed, x_src, fakes).tolist())
                fake_acts.setdefault((src, trg), []).append(_fake_activations(inception, fakes))
                if out_dir:
                    _write_pngs(out_dir, task, fakes.cpu().numpy(), n_seen - batch.shape[0])
            results[f"LPIPS_{mode}/{task}"] = float(np.mean(lpips_vals)) if lpips_vals else 0.0
            results[f"FaceIDcos_{mode}/{task}"] = float(np.mean(id_vals)) if id_vals else 0.0

    # FID real against fake per (src -> trg) task (eval.py:123-148), and
    # pooled per target domain where it has more than one source.
    real_acts: dict[str, np.ndarray] = {}
    domain_acts: dict[str, list[np.ndarray]] = {}
    for (src, trg), acts in sorted(fake_acts.items()):
        if trg not in real_acts:
            real = face.eval_batches(os.path.join(val_root, trg), img_size, batch_size, imagenet_normalize=True)
            real_acts[trg] = collect_activations(inception, real)
        acts = np.concatenate(acts)
        results[f"FID_{mode}/{src}2{trg}"] = fid_from_activations(real_acts[trg], acts)
        domain_acts.setdefault(trg, []).append(acts)
    for trg, acts in domain_acts.items():
        if len(acts) > 1:
            results[f"FID_domain_{mode}/{trg}"] = fid_from_activations(real_acts[trg], np.concatenate(acts))

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"metrics_{mode}_{step}.json"), "w") as f:
            json.dump(results, f, indent=2)
    return results
