"""Privacy-preserving captioning trainer (reference train.py's iteration).

Port of ``ppvision_tpu/train/caption.py``.  Per batch (reference
``Image_Caption/train.py:243-352``):

1. the lens forms the privacy sensor image (+ the PSF mask loss, mode
   "3"), with height noise from the step's generator;
2. the ResNet-101 encoder in train mode (stem and ``layer1`` frozen,
   layers 2-4 fine-tuned, models.py:43-54) -> 36x36x2048 features;
3. the attention-LSTM decoder, teacher-forced, dropout from the same
   generator;
4. ``loss = 0.4*(CE + alpha_c*dsr) + 6*(1 - MSE(orig, sensor))`` (or
   ``1 - SSIM`` with ``camera_loss="SSIM"``) ``+ 30*psf_loss``
   (train.py:280-286);
5. three ``torch.optim.Adam`` (betas (0.9, 0.999), eps 1e-8): the
   camera's at ``camera_lr``, unclipped; the encoder's and the decoder's
   after an elementwise clamp of their gradients to +-``grad_clip``
   (optax's ``clip``, the reference's ``clip_gradient``).  The stem's
   and ``layer1``'s gradients are zero, so Adam leaves them where they
   are.  The reference's zernike clamp (train.py:322-323) indexes
   ``[1:]`` of a one-coefficient tensor, a no-op, so it is not applied.

Every BN of the encoder, the frozen stem's too, takes its new running
statistics from the step's forward, as the JAX step keeps
``enc_mut['batch_stats']`` whole.  ``cfg.remat`` runs the encoder under
``torch.utils.checkpoint`` (non-reentrant).  The forward's parts and the
optimizer run in ``torch.profiler.record_function`` ranges
(``caption.camera``, ``caption.encoder``, ``caption.decoder``,
``caption.loss``, ``caption.optimizer``), and the backward with its
gradient all-reduce in ``caption.backward`` on the calling thread; the
backward's kernels run on autograd's device thread, under its
``evaluate_function`` names.

Under a mesh (``parallel/mesh.py``; call the step inside ``with
mesh:``) each rank takes its block of the global batch and the same
generator state: the gradients are averaged over the ranks before the
clamp, as JAX clips the global gradient, the BNs take the global
batch's statistics, the lens the global max, the loss the global token
count, and the metrics come back as the global ones.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ..config import CaptionConfig
from ..metrics.psnr_ssim import ssim
from ..models.captioner import AttentionLSTMDecoder, caption_loss, init_decoder_
from ..models.resnet import CaptionEncoder, commit_batch_stats, init_encoder_
from ..optics.lens import LensConstants, LensSpec, OpticsZernike, lens_apply
from ..parallel.mesh import all_reduce_grads, mean_metrics
from ..utils.device import resolve_device

__all__ = ["CaptionTrainState", "encoder_trainable", "init_caption", "make_caption_train_step",
           "make_optimizers"]


@dataclasses.dataclass
class CaptionTrainState:
    camera: OpticsZernike
    encoder: CaptionEncoder
    decoder: AttentionLSTMDecoder
    opt_camera: torch.optim.Optimizer
    opt_encoder: torch.optim.Optimizer
    opt_decoder: torch.optim.Optimizer
    step: int = 0

    def state_dict(self) -> dict:
        return {"camera": self.camera.state_dict(), "encoder": self.encoder.state_dict(),
                "decoder": self.decoder.state_dict(), "opt_camera": self.opt_camera.state_dict(),
                "opt_encoder": self.opt_encoder.state_dict(), "opt_decoder": self.opt_decoder.state_dict(),
                "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        for k in ("camera", "encoder", "decoder", "opt_camera", "opt_encoder", "opt_decoder"):
            getattr(self, k).load_state_dict(sd[k])
        self.step = int(sd["step"])


def encoder_trainable(name: str) -> bool:
    """Fine-tune ResNet stages >= layer2 only (reference models.py:43-54):
    the stem (``conv1``, ``bn1``) and ``layer1`` are frozen."""
    return name.split(".")[0] not in ("conv1", "bn1", "layer1")


def make_optimizers(cfg: CaptionConfig, camera, encoder, decoder):
    """(camera, encoder, decoder) Adams.  ``foreach``: in-place updates."""
    def adam(params, lr):
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, foreach=True)

    return (
        adam([camera.zernike_coeffs_train], cfg.camera_lr),
        adam(list(encoder.parameters()), cfg.encoder_lr),
        adam(list(decoder.parameters()), cfg.decoder_lr),
    )


def init_caption(
    seed: int,
    cfg: CaptionConfig,
    vocab_size: int,
    lens_spec: LensSpec,
    camera: OpticsZernike | None = None,
    encoder_stages: tuple[int, ...] = (3, 4, 23, 3),
    dtype: torch.dtype | None = None,
    device="cuda",
) -> CaptionTrainState:
    """The encoder (torchvision's init) and decoder (the reference's) from
    ``seed`` and ``seed + 1``, the camera (the reference init unless
    given) and the three optimizers, on ``device``."""
    dev = resolve_device(device)
    encoder = init_encoder_(CaptionEncoder(cfg.encoded_image_size, encoder_stages, dtype), seed)
    decoder = init_decoder_(
        AttentionLSTMDecoder(vocab_size, cfg.emb_dim, cfg.decoder_dim, cfg.attention_dim, dropout=cfg.dropout),
        seed + 1,
    )
    camera = OpticsZernike(lens_spec) if camera is None else camera
    camera, decoder = camera.to(dev), decoder.to(dev)
    encoder = encoder.to(dev, memory_format=torch.channels_last)
    return CaptionTrainState(camera, encoder, decoder, *make_optimizers(cfg, camera, encoder, decoder))


def make_caption_train_step(
    cfg: CaptionConfig,
    lens_spec: LensSpec,
    lens_consts: LensConstants,
    camera_train: bool = True,
):
    """Returns ``train_step(state, batch, generator) -> metrics``, which
    updates ``state`` in place.  ``batch`` holds NHWC ``images`` in
    [0, 1], ``captions`` (B, L) and ``caption_lengths`` (B,) as tensors
    on the state's device; ``generator`` (a ``torch.Generator`` there)
    draws the lens's height noise and the decoder's dropout."""

    def train_step(state: CaptionTrainState, batch: dict, generator: torch.Generator) -> dict:
        with torch.enable_grad():
            return _step(state, batch, generator)

    def _step(state: CaptionTrainState, batch: dict, generator: torch.Generator) -> dict:
        enc, dec = state.encoder, state.decoder
        enc.train()
        dec.train()
        images = batch["images"]
        with record_function("caption.camera"):
            res = lens_apply(state.camera, lens_consts, lens_spec, images, mask_mode=cfg.mask_mode,
                             generator=generator)
        with record_function("caption.encoder"):
            if cfg.remat:
                enc_out = checkpoint(enc, res.sensor, use_reentrant=False)
            else:
                enc_out = enc(res.sensor)
        with record_function("caption.decoder"):
            out = dec(enc_out, batch["captions"], batch["caption_lengths"], generator)
        with record_function("caption.loss"):
            ce, dsr, acc5 = caption_loss(out, batch["captions"], cfg.alpha_c)
            ssim_val = ssim(images.to(res.sensor.dtype), res.sensor)
            if cfg.camera_loss == "MSE":
                cam_term = 1.0 - torch.mean((images - res.sensor) ** 2)
            else:
                cam_term = 1.0 - ssim_val
            loss = cfg.w_caption * (ce + cfg.alpha_c * dsr) + cfg.w_ssim * cam_term + cfg.w_psf * res.psf_loss

        cam_p = [state.camera.zernike_coeffs_train]
        enc_named = list(enc.named_parameters())
        enc_p = [p for n, p in enc_named if encoder_trainable(n)]
        dec_p = list(dec.parameters())
        with record_function("caption.backward"):
            grads = all_reduce_grads(torch.autograd.grad(loss, cam_p + enc_p + dec_p))
        g_cam, g_enc, g_dec = grads[:1], iter(grads[1 : 1 + len(enc_p)]), grads[1 + len(enc_p) :]

        with record_function("caption.optimizer"):
            if not camera_train:
                g_cam = [torch.zeros_like(g) for g in g_cam]
            _apply(state.opt_camera, cam_p, g_cam)
            clip = cfg.grad_clip
            g_enc = [next(g_enc).clamp(-clip, clip) if encoder_trainable(n) else torch.zeros_like(p)
                     for n, p in enc_named]
            _apply(state.opt_encoder, [p for _, p in enc_named], g_enc)
            _apply(state.opt_decoder, dec_p, [g.clamp(-clip, clip) for g in g_dec])
            commit_batch_stats(enc)
        state.step += 1
        return mean_metrics({k: v.detach() for k, v in dict(loss=loss, ce=ce, dsr=dsr, top5=acc5, ssim=ssim_val,
                                                              psf_loss=res.psf_loss).items()})

    return train_step


def _apply(opt: torch.optim.Optimizer, params, grads) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None
