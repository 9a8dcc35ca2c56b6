"""RAFT temporal-consistency evaluation for de-id video.

Port of ``ppvision_tpu/metrics/temporal.py`` (BASELINE config 5):
``flow_consistency`` is the mean end-point error between the optical
flow of consecutive source frames and the flow of the matching
anonymized frames; 0 means the anonymization moves exactly like the
source.  Both sequences' consecutive pairs ride the batch axis of one
RAFT call, which runs without autograd on the RAFT module's device.
"""

from __future__ import annotations

import torch

__all__ = ["flow_consistency", "make_flow_consistency_fn"]


def make_flow_consistency_fn(raft, iters: int = 12):
    """A scorer of (T, H, W, 3) [0, 1] source and anonymized sequences
    (tensors or arrays) -> a scalar tensor on the RAFT module's device."""
    dev = next(raft.parameters()).device

    @torch.no_grad()
    def score(src_frames, fake_frames) -> torch.Tensor:
        src = torch.as_tensor(src_frames, device=dev) * 255.0
        fake = torch.as_tensor(fake_frames, device=dev) * 255.0
        f1 = torch.cat([src[:-1], fake[:-1]], dim=0)
        f2 = torch.cat([src[1:], fake[1:]], dim=0)
        flow = raft(f1, f2, iters=iters)
        n = src.shape[0] - 1
        epe = torch.sqrt(torch.sum((flow[:n] - flow[n:]) ** 2, dim=-1) + 1e-12)
        return torch.mean(epe)

    return score


def flow_consistency(raft, src_frames, fake_frames, iters: int = 12) -> float:
    """One-shot wrapper around :func:`make_flow_consistency_fn`."""
    return float(make_flow_consistency_fn(raft, iters=iters)(src_frames, fake_frames))
