"""Teacher-forced captioning validation (reference ``validate`` /
``eval/val.py``): greedy-from-teacher-forcing hypotheses, corpus BLEU-4
and loss/top-5 meters over a VAL split.

Port of ``ppvision_tpu/metrics/val_caption.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import CaptionConfig
from ..models.captioner import AttentionLSTMDecoder, caption_loss
from ..models.resnet import CaptionEncoder
from ..optics.lens import LensConstants, LensSpec, OpticsZernike, lens_apply
from ..utils.logging import AverageMeter
from .text import bleu_scores

__all__ = ["validate_teacher_forced"]


@torch.no_grad()
def validate_teacher_forced(
    cfg: CaptionConfig,
    encoder: CaptionEncoder,
    decoder: AttentionLSTMDecoder,
    camera: tuple[OpticsZernike, LensConstants, LensSpec] | None,
    batches,
    word_map: dict[str, int],
    max_batches: int | None = None,
) -> dict[str, float]:
    """Loss, top-5 accuracy and token-id BLEU-4 of the teacher-forced
    argmax over ``batches`` (numpy dicts as ``caption_batches`` yields),
    on the encoder's device, the modules in eval mode."""
    start, end, pad = word_map["<start>"], word_map["<end>"], word_map["<pad>"]
    special = {start, end, pad}
    encoder.eval()
    decoder.eval()
    dev = next(decoder.parameters()).device
    dtype = next(decoder.parameters()).dtype

    losses, top5 = AverageMeter(), AverageMeter()
    references, hypotheses = [], []
    for bi, batch in enumerate(batches):
        if max_batches is not None and bi >= max_batches:
            break
        x = torch.as_tensor(np.asarray(batch["images"]))
        x = x.to(dev, torch.promote_types(x.dtype, dtype))
        caps = torch.from_numpy(np.asarray(batch["captions"])).to(dev)
        caplens = torch.from_numpy(np.asarray(batch["caption_lengths"])).to(dev)
        if camera is not None:
            lens, consts, spec = camera
            x = lens_apply(lens, consts, spec, x, mask_mode=cfg.mask_mode).sensor
        out = decoder(encoder(x), caps, caplens)
        ce, dsr, acc5 = caption_loss(out, caps, cfg.alpha_c)
        preds = out.predictions.argmax(dim=-1).cpu().numpy()
        n = int(np.sum(batch["caption_lengths"] - 1))
        losses.update(float(ce + cfg.alpha_c * dsr), n)
        top5.update(float(acc5), n)
        for j in range(preds.shape[0]):
            ln = int(batch["caption_lengths"][j]) - 1
            hypotheses.append([int(t) for t in preds[j, :ln] if int(t) not in special])
            refs = batch.get("all_captions")
            if refs is not None:
                references.append([[int(t) for t in cap if int(t) not in special] for cap in refs[j]])
            else:
                references.append([[int(t) for t in batch["captions"][j] if int(t) not in special]])
    # Token-id BLEU, exactly as the reference's validate computes it
    # over encoded captions (train.py:428-447).
    str_refs = [[[str(t) for t in r] for r in rs] for rs in references]
    str_hyps = [[str(t) for t in h] for h in hypotheses]
    bleu4 = bleu_scores(str_refs, str_hyps)["bleu4"]
    return {"loss": losses.avg, "top5": top5.avg, "bleu4": float(bleu4)}
