"""Captioning evaluation: beam-search decode + text metrics + privacy metrics.

Port of ``ppvision_tpu/metrics/eval_caption.py`` (the reference's
``eval/eval_total.py``): per batch of test images, form the sensor image
(camera), record per-image PSNR/SSIM against the original (privacy
metrics, eval_total.py:78-85), encode and beam-search decode (k = 5,
<= 50 steps); then corpus BLEU-1..4, METEOR, ROUGE-Lsum and CIDEr, and
the Captions/Metrics reports (eval_total.py:204-296).

``evaluate_captions`` runs two halves in turn: :func:`decode_captions`,
the device half (camera, encoder, beam search, image metrics), which
returns the hypotheses, the references and the per-image PSNR/SSIM, and
:func:`score_captions`, the host half (the text scores).  Each part of
the device half runs in a ``torch.profiler.record_function`` range
(``caption.camera``, ``caption.encoder``, ``caption.beam_search``,
``caption.image_metrics``), so a profile splits its time by part.

The camera baselines of the reference, ``eval_model_0`` (no camera) and
``eval_no_camera`` (16x16 low-res), are the ``camera_mode`` options.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
from torch.profiler import record_function

from ..config import CaptionConfig
from ..models.captioner import AttentionLSTMDecoder, beam_search_batch
from ..models.resnet import CaptionEncoder
from ..ops.image import resize_bilinear
from ..optics.lens import LensConstants, LensSpec, OpticsZernike, lens_apply
from .psnr_ssim import psnr, ssim
from .text import bleu_scores, cider_score, meteor_avg, rouge_lsum

__all__ = ["decode_captions", "evaluate_captions", "score_captions"]


def _decode_tokens(ids, rev_word_map, stop_ids) -> list[str]:
    out = []
    for t in ids:
        t = int(t)
        if t in stop_ids:
            if t == stop_ids[-1]:  # <end>
                break
            continue
        out.append(rev_word_map.get(t, "<unk>"))
    return out


def _image_metrics(x: torch.Tensor, sensor: torch.Tensor) -> tuple[list[float], list[float]]:
    """Per-image PSNR and SSIM of the sensor images against the originals
    (the reference computes them an image at a time, eval_total.py:78-85)."""
    psnrs = torch.stack([psnr(a[None], b[None]) for a, b in zip(x, sensor)])
    ssims = ssim(x, sensor, size_average=False)
    return psnrs.cpu().tolist(), ssims.cpu().tolist()


@torch.no_grad()
def decode_captions(
    cfg: CaptionConfig,
    encoder: CaptionEncoder,
    decoder: AttentionLSTMDecoder,
    camera: tuple[OpticsZernike, LensConstants, LensSpec] | None,
    dataset,
    word_map: dict[str, int],
    beam_size: int | None = None,
    camera_mode: str = "lens",
    max_images: int | None = None,
    batch_size: int = 16,
) -> dict:
    """The device half: ``hypotheses`` and ``references`` (word lists)
    and the per-image ``psnrs`` and ``ssims`` (lens mode only) of the
    first ``max_images`` images of ``dataset`` (``cpi``, ``len`` and
    ``dataset[i]`` -> (image, caption, length, all captions)).  The lens
    normalizes each batch of ``batch_size`` images by its one max, as
    the JAX package's batched eval does."""
    beam_size = beam_size or cfg.beam_size
    rev = {v: k for k, v in word_map.items()}
    start, end, pad = word_map["<start>"], word_map["<end>"], word_map["<pad>"]
    stop_ids = [pad, start, end]
    encoder.eval()
    decoder.eval()
    dev = next(decoder.parameters()).device
    dtype = next(decoder.parameters()).dtype

    references, hypotheses, psnrs, ssims = [], [], [], []
    cpi = dataset.cpi
    n_images = len(dataset) // cpi
    if max_images is not None:
        n_images = min(n_images, max_images)
    for lo in range(0, n_images, batch_size):
        imgs, allcaps_b = [], []
        for i in range(lo, min(lo + batch_size, n_images)):
            img, _, _, allcaps = dataset[i * cpi]
            imgs.append(img)
            allcaps_b.append(allcaps)
        x = torch.as_tensor(np.stack(imgs))
        x = x.to(dev, torch.promote_types(x.dtype, dtype))
        if camera is not None and camera_mode == "lens":
            lens, consts, spec = camera
            with record_function("caption.camera"):
                sensor = lens_apply(lens, consts, spec, x, mask_mode=cfg.mask_mode).sensor
            with record_function("caption.image_metrics"):
                p, s = _image_metrics(x, sensor)
            psnrs.extend(p)
            ssims.extend(s)
        elif camera_mode == "lowres":
            # 16x16 -> full-res baseline (reference eval_no_camera.py:29).
            h = x.shape[1]
            nchw = x.permute(0, 3, 1, 2)
            sensor = resize_bilinear(resize_bilinear(nchw, (16, 16)), (h, h)).permute(0, 2, 3, 1)
        else:
            sensor = x
        with record_function("caption.encoder"):
            feats = encoder(sensor)
        with record_function("caption.beam_search"):
            tokens_b, _ = beam_search_batch(decoder, feats, start, end, beam_size, cfg.max_caption_len)
            tokens_b = tokens_b.cpu().numpy()
        for tokens, allcaps in zip(tokens_b, allcaps_b):
            hypotheses.append(_decode_tokens(tokens, rev, stop_ids))
            references.append([_decode_tokens(np.asarray(c), rev, stop_ids) for c in allcaps])
    return dict(hypotheses=hypotheses, references=references, psnrs=psnrs, ssims=ssims)


def score_captions(decoded: dict) -> dict[str, float]:
    """The host half: corpus BLEU-1..4, METEOR, ROUGE-Lsum and CIDEr of
    ``decode_captions``' output, and the mean PSNR/SSIM where it has them."""
    references, hypotheses = decoded["references"], decoded["hypotheses"]
    results = bleu_scores(references, hypotheses)
    results["meteor"] = meteor_avg(references, hypotheses)
    results["rouge_lsum"] = rouge_lsum(references, hypotheses)
    results["cider"], _ = cider_score(references, hypotheses)
    if decoded["psnrs"]:
        results["psnr"] = float(np.mean(decoded["psnrs"]))
        results["ssim"] = float(np.mean(decoded["ssims"]))
    return results


def evaluate_captions(
    cfg: CaptionConfig,
    encoder: CaptionEncoder,
    decoder: AttentionLSTMDecoder,
    camera: tuple[OpticsZernike, LensConstants, LensSpec] | None,
    dataset,
    word_map: dict[str, int],
    beam_size: int | None = None,
    camera_mode: str = "lens",  # 'lens' | 'none' | 'lowres'
    max_images: int | None = None,
    out_dir: str | None = None,
    batch_size: int = 16,
) -> dict[str, float]:
    """``decode_captions`` then ``score_captions``; with ``out_dir``,
    writes ``Captions.txt``, ``Metrics.txt`` and ``metrics.json`` there."""
    beam_size = beam_size or cfg.beam_size
    decoded = decode_captions(cfg, encoder, decoder, camera, dataset, word_map, beam_size, camera_mode,
                              max_images, batch_size)
    results = score_captions(decoded)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "Captions.txt"), "w") as f:
            for hyp in decoded["hypotheses"]:
                f.write(" ".join(hyp) + "\n")
        with open(os.path.join(out_dir, "Metrics.txt"), "w") as f:
            f.write("-" * 72 + "\n")
            for k, v in results.items():
                f.write(f"{k} @ beam size {beam_size}: {v:.4f}\n")
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(results, f, indent=2)
    return results
