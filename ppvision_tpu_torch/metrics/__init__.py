"""Evaluation metrics of the port: RAFT temporal flow consistency, the
GAN eval (LPIPS, FID, face-ID), PSNR/SSIM, and the captioner's eval
(beam-search captions scored by BLEU, METEOR, ROUGE-Lsum and CIDEr)."""

from .temporal import flow_consistency, make_flow_consistency_fn

__all__ = ["flow_consistency", "make_flow_consistency_fn"]
