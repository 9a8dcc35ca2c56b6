"""Face-DeId GAN trainer: the reference Solver's iteration in PyTorch.

Port of ``ppvision_tpu/train/gan.py`` (reference
``Face-DeId/core/solver.py:107-248``).  Each iteration runs, in order:

1. the privacy image from the frozen camera (or the batch's ``x_priv``)
   and the heatmap masks from the frozen ``fan_priv``, without autograd;
2. a discriminator step on latent-style fakes, with R1 on the real
   references (a gradient of a gradient, solver.py:379-388);
3. a discriminator step on reference-style fakes;
4. a generator step from latent styles, updating G, the mapping network
   and the style encoder, with the RAFT flow loss and the value-only
   heatmap L1;
5. a generator step from reference styles, updating G only, with LPIPS
   and the flow loss;
6. the EMA of G, the mapping network and the style encoder, in the JAX
   form ``p + beta * (e - p)``.

With ``TrainConfig.remat`` G and D run under
``torch.utils.checkpoint`` (non-reentrant), as the JAX step wraps them
in ``jax.checkpoint``.

Under a mesh (``parallel/mesh.py``; call the step inside ``with
mesh:``) each rank takes its block of the global batch: every sub-step's
gradients are averaged over the ranks before its update, the
generator's skip mean is the global batch's, and the metrics come back
as the global ones, so the updates, the EMA and Adam's moments stay the
same on every rank.

Each sub-step takes its gradients with ``torch.autograd.grad`` over the
nets it updates, and only those nets' parameters take gradients while it
runs, so no step leaves ``.grad`` on another net and no kernel computes
a weight gradient nobody asked for.  The optimizers are
``torch.optim.Adam(weight_decay=...)``: the decay is added to the
gradient before the moments, as optax's ``add_decayed_weights`` ->
``scale_by_adam`` does.  The heatmap L1 and the fake-side heatmaps carry
no gradient, as in the reference (wing.py:241); the cycle branch's FAN
call whose masks are discarded (solver.py:355-357) is not run.

Inputs and images are NHWC like the JAX package's; the nets run NCHW.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Callable

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import FaceDeIdConfig
from ..models.fan import FAN, get_heatmap
from ..models.stargan import build_gan_models, init_params_
from ..ops.image import resize_bilinear
from ..optics.camera import Camera, CameraConstants, camera_apply
from ..parallel.mesh import all_reduce_grads, mean_metrics
from ..utils.device import resolve_device

__all__ = [
    "EMA_NETS",
    "GAN_NETS",
    "FrozenNets",
    "GANTrainState",
    "adv_loss",
    "init_gan",
    "lambda_ds_schedule",
    "make_optimizers",
    "make_train_step",
]

GAN_NETS = ("generator", "mapping_network", "style_encoder", "discriminator")
EMA_NETS = ("generator", "mapping_network", "style_encoder")


@dataclasses.dataclass
class GANTrainState:
    """The trained nets, their optimizers, the EMA copies and the count
    of iterations taken; a train step updates it in place."""

    nets: dict[str, nn.Module]
    optims: dict[str, torch.optim.Optimizer]
    ema: dict[str, nn.Module]
    step: int = 0


@dataclasses.dataclass
class FrozenNets:
    """The nets a train step runs but does not train."""

    camera: Camera
    camera_consts: CameraConstants
    fan: FAN  # pretrained FAN (clean images)
    fan_priv: FAN  # FAN trained on privacy images


def make_optimizers(cfg: FaceDeIdConfig, nets: dict[str, nn.Module]) -> dict[str, torch.optim.Optimizer]:
    """Adam with torch-style (pre-moment) weight decay; the mapping
    network takes the slow ``f_lr`` (solver.py:60-67)."""
    t = cfg.train
    # foreach: its in-place updates bump each parameter's version, which
    # the conv modules key their packed kernel weights on.
    return {
        name: torch.optim.Adam(
            nets[name].parameters(), lr=t.f_lr if name == "mapping_network" else t.lr,
            betas=(t.beta1, t.beta2), weight_decay=t.weight_decay, foreach=True,
        )
        for name in GAN_NETS
    }


def init_gan(seed: int, cfg: FaceDeIdConfig, device="cuda") -> GANTrainState:
    """The four nets with fresh seeded weights (the reference's he-init),
    their EMA copies and optimizers, on the card unless
    ``device="cpu"``.  Parameters are f32, or f64 under f64 compute."""
    dev = resolve_device(device)
    m = cfg.model
    dtype = getattr(torch, m.compute_dtype)
    nets = build_gan_models(
        img_size=m.img_size, style_dim=m.style_dim, latent_dim=m.latent_dim,
        num_domains=m.num_domains, w_hpf=m.w_hpf, max_conv_dim=m.max_conv_dim, dtype=dtype,
    )
    pdtype = torch.promote_types(dtype, torch.float32)
    for i, name in enumerate(GAN_NETS):
        nets[name] = init_params_(nets[name], seed + i).to(dev, pdtype)
    ema = {name: copy.deepcopy(nets[name]).requires_grad_(False) for name in EMA_NETS}
    return GANTrainState(nets=nets, optims=make_optimizers(cfg, nets), ema=ema)


def adv_loss(logits: torch.Tensor, target: int) -> torch.Tensor:
    """BCE-with-logits against a constant target (solver.py:372-376), as
    ``jax.nn.softplus`` computes it."""
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    return torch.mean(torch.logaddexp(-logits if target == 1 else logits, zero))


def lambda_ds_schedule(cfg: FaceDeIdConfig, step: int) -> float:
    """Linear decay of the diversity weight to 0 over ds_iter
    (solver.py:127-134, 192-193)."""
    frac = 1.0 - float(step) / float(cfg.loss.ds_iter)
    return cfg.loss.lambda_ds * min(max(frac, 0.0), 1.0)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _train_only(nets: dict[str, nn.Module], names) -> list[nn.Parameter]:
    """Let only the named nets' parameters take gradients; returns them."""
    for name, net in nets.items():
        net.requires_grad_(name in names)
    return [p for name in names for p in nets[name].parameters()]


def _grads(loss: torch.Tensor, params: list[nn.Parameter]) -> list[torch.Tensor]:
    """d loss / d params, averaged over the ranks under a mesh; a
    parameter the loss does not reach gets zeros, as a JAX gradient does
    (Adam's weight decay still moves it)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return all_reduce_grads([torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)])


def _apply(state: GANTrainState, names, grads: list[torch.Tensor]) -> None:
    """One optimizer step for each named net with the given gradients."""
    it = iter(grads)
    for name in names:
        params = list(state.nets[name].parameters())
        for p in params:
            p.grad = next(it)
        state.optims[name].step()
        for p in params:
            p.grad = None


def make_train_step(
    cfg: FaceDeIdConfig,
    lpips_fn: Callable | None = None,
    flow_fn: Callable | None = None,
    grad_hook: Callable | None = None,
):
    """The per-iteration update ``train_step(state, frozen, batch) ->
    metrics``: it updates ``state`` in place and returns the losses as
    0-d tensors under the JAX package's names (``D/latent_real``, ...,
    ``G/ref_lpips``, ``G/lambda_ds``).

    ``batch`` holds NHWC ``x_src``, ``x_ref``, ``x_ref2`` in [0, 1],
    integer ``y_src`` and ``y_ref``, latents ``z_trg`` and ``z_trg2``,
    and may hold the private images ``x_priv`` in place of the camera's
    (the reference's paired datasets, data_loader.py:23-49).
    ``lpips_fn(x, y) -> scalar`` and ``flow_fn(a, b) -> scalar`` add the
    LPIPS and RAFT-flow terms; without them those terms are absent.
    ``grad_hook(sub_step, grads)``, where given, sees each sub-step's
    gradients ({net: [tensor, ...]}) before its update, and may return
    others in the same form to be applied in their place."""
    lc = cfg.loss
    fan_size = cfg.model.fan_input_size

    def train_step(state: GANTrainState, frozen: FrozenNets, batch: dict) -> dict[str, torch.Tensor]:
        with torch.enable_grad():
            return _step(state, frozen, batch)

    def _step(state, frozen, batch):
        nets = state.nets
        gen, mapn, senc, disc = (nets[k] for k in GAN_NETS)
        dev = next(gen.parameters()).device
        if cfg.train.remat:
            # Recompute G's and D's activations in the backward instead of
            # keeping them (jax.checkpoint around g_apply and d_apply in the
            # JAX package): the same values, about one more forward, a lower
            # peak.  R1's gradient of a gradient goes through it.
            gen = functools.partial(checkpoint, nets["generator"], use_reentrant=False)
            disc = functools.partial(checkpoint, nets["discriminator"], use_reentrant=False)
        b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        x_src, x_ref, x_ref2 = b["x_src"], _nchw(b["x_ref"]), _nchw(b["x_ref2"])
        y_src, y_trg = b["y_src"].long(), b["y_ref"].long()
        z_trg, z_trg2 = b["z_trg"], b["z_trg2"]
        metrics: dict[str, torch.Tensor] = {}

        # Frozen camera + privacy heatmaps (solver.py:144-147).
        with torch.no_grad():
            if "x_priv" in b:
                x_real_hwc = b["x_priv"]
            else:
                x_real_hwc, _ = camera_apply(frozen.camera, frozen.camera_consts, x_src)
            priv = get_heatmap(frozen.fan_priv, x_real_hwc, privacy=True, input_size=fan_size)
            masks = tuple(_nchw(m) for m in priv)
            x_real = _nchw(x_real_hwc)
            mask_org = None
            if flow_fn is not None:
                hm = get_heatmap(frozen.fan, x_src, delimiter=True, input_size=fan_size)[0]
                hm = _nhwc(resize_bilinear(_nchw(hm), tuple(x_src.shape[1:3])))
                mask_org = (hm > 0.5).to(x_src.dtype)
        lam_ds = lambda_ds_schedule(cfg, state.step)

        def hook(sub, names, grads):
            if grad_hook is None:
                return grads
            it = iter(grads)
            out = grad_hook(sub, {n: [next(it) for _ in nets[n].parameters()] for n in names})
            return grads if out is None else [g for n in names for g in out[n]]

        # --- D steps (latent, then reference styles) ---
        def d_step(tag, style):
            params = _train_only(nets, ("discriminator",))
            # Real branch + R1 on the real references (solver.py:150-158, 292-304).
            x = x_ref.detach().requires_grad_(True)
            out = disc(x, y_trg)
            loss_real = adv_loss(out, 1)
            (grad_x,) = torch.autograd.grad(out.sum(), x, create_graph=True)
            reg = 0.5 * torch.mean(torch.sum(grad_x**2, dim=(1, 2, 3)))
            # Fake branch, generator frozen (solver.py:306-312).
            with torch.no_grad():
                x_fake = gen(x_real, style, masks)
            loss_fake = adv_loss(disc(x_fake, y_trg), 0)
            loss = loss_real + loss_fake + lc.lambda_reg * reg
            grads = hook(f"D/{tag}", ("discriminator",), _grads(loss, params))
            _apply(state, ("discriminator",), grads)
            metrics.update({f"D/{tag}_real": loss_real.detach(), f"D/{tag}_fake": loss_fake.detach(),
                            f"D/{tag}_reg": reg.detach()})

        with torch.no_grad():
            s_lat = mapn(z_trg, y_trg)
        d_step("latent", s_lat)
        with torch.no_grad():
            s_ref = senc(x_ref, y_trg)
        d_step("ref", s_ref)

        # --- G steps (compute_g_loss, solver.py:322-364) ---
        def flow_term(x_fake):
            flow = flow_fn(x_src * mask_org * 255.0, _nhwc(x_fake) * mask_org * 255.0)
            return flow * lc.lambda_flow

        def g_loss(s_trg, s_trg2, s_org):
            x_fake = gen(x_real, s_trg, masks)
            loss_adv = adv_loss(disc(x_fake, y_trg), 1)
            s_pred = senc(x_fake, y_trg)
            loss_sty = lc.lambda_sty * torch.mean(torch.abs(s_pred - s_trg))
            with torch.no_grad():
                x_fake2 = gen(x_real, s_trg2, masks)
            loss_ds = lam_ds * torch.mean(torch.abs(x_fake - x_fake2))
            x_rec = gen(x_fake, s_org, None)
            loss_cyc = lc.lambda_cyc * torch.mean(torch.abs(x_rec - x_real))
            loss = loss_adv + loss_sty - loss_ds + loss_cyc
            aux = dict(adv=loss_adv, sty=loss_sty, ds=loss_ds, cyc=loss_cyc)
            return loss, aux, x_fake

        # Latent styles: updates G, the mapping network and the style encoder.
        names = ("generator", "mapping_network", "style_encoder")
        params = _train_only(nets, names)
        s_trg = mapn(z_trg, y_trg)
        with torch.no_grad():
            s_trg2 = mapn(z_trg2, y_trg)
        loss, aux, x_fake = g_loss(s_trg, s_trg2, senc(x_real, y_src))
        if flow_fn is not None:
            aux["flow"] = flow_term(x_fake)
            loss = loss + aux["flow"]
        if lc.lambda_heatmap:
            # Heatmap L1: value only (both sides no-grad in the reference).
            with torch.no_grad():
                mf = get_heatmap(frozen.fan, _nhwc(x_fake), privacy=False, input_size=fan_size)[0]
                aux["heatmap_l1"] = torch.mean(torch.abs(mf - priv[0])) * lc.lambda_heatmap
            loss = loss + aux["heatmap_l1"]
        grads = hook("G/latent", names, _grads(loss, params))
        _apply(state, names, grads)
        metrics.update({f"G/latent_{k}": v.detach() for k, v in aux.items()})

        # Reference styles: updates G only.
        params = _train_only(nets, ("generator",))
        with torch.no_grad():
            s_trg, s_trg2, s_org = senc(x_ref, y_trg), senc(x_ref2, y_trg), senc(x_real, y_src)
        loss, aux, x_fake = g_loss(s_trg, s_trg2, s_org)
        if lpips_fn is not None:
            aux["lpips"] = torch.abs(lpips_fn(b["x_ref"], _nhwc(x_fake))) * lc.lambda_lpips
            loss = loss + aux["lpips"]
        if flow_fn is not None:
            aux["flow"] = flow_term(x_fake)
            loss = loss + aux["flow"]
        grads = hook("G/ref", ("generator",), _grads(loss, params))
        _apply(state, ("generator",), grads)
        metrics.update({f"G/ref_{k}": v.detach() for k, v in aux.items()})
        _train_only(nets, GAN_NETS)

        # --- EMA (solver.py:187-189, 367-369) ---
        beta = cfg.train.ema_beta
        with torch.no_grad():
            for name in EMA_NETS:
                for e, p in zip(state.ema[name].parameters(), nets[name].parameters()):
                    e.copy_(p + beta * (e - p))
        metrics["G/lambda_ds"] = torch.tensor(lam_ds, dtype=torch.float64)
        state.step += 1
        return mean_metrics(metrics)

    return train_step
