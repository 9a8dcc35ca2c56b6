"""Plain privacy-preserving captioning step (Show, Attend and Tell behind
a learned Fresnel lens), float32 with the optics in float64, over state
dicts.

Written from Image_Caption/train.py, models.py and Camera/Lens.py of
carlosh93/privacy-preserving-vision: the lens forms the sensor image
(height noise and the central-disk PSF crop and penalty), a ResNet-101
(v1.5, train-mode batch norm, stem and layer1 frozen) pooled to 36x36
encodes it, the attention-LSTM decoder is teacher-forced over the
padded captions with dropout 0.5 on its hidden states, and the loss is
0.4 (CE over the valid tokens + the doubly-stochastic term) + 6 (1 -
MSE(image, sensor)) + 30 psf_loss.  Three Adams step the lens, the
encoder and the decoder, the last two after an elementwise clamp of
their gradients.

Where the step draws random numbers it draws them from the
``torch.Generator`` it is handed, in the order the port draws them
(the lens's (N, N) height noise, then the (B, L - 1, D) dropout mask),
so both sides see the same noise.  Batch-norm running statistics take
Flax's update (momentum 0.9, the biased batch variance).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import optics

__all__ = ["encoder_forward", "decoder_forward", "step_loss", "train_steps", "trainable", "fp8", "bf16"]


def trainable(module: str, name: str) -> bool:
    """The lens's defocus, the encoder from layer2 on, the whole decoder."""
    if module == "camera":
        return name == "zernike_coeffs_train"
    if module == "encoder":
        return name.split(".")[0] not in ("conv1", "bn1", "layer1") and not name.endswith(
            ("running_mean", "running_var", "num_batches_tracked"))
    return module == "decoder"


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale (its maximum
    at 448), the gradient passed straight through: the precision below
    bf16 for the lower-precision control."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t.detach())


def bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 and back (its gradient passes through):
    the encoder's own precision where a control lowers the decoder."""
    return t.to(torch.bfloat16).to(t.dtype)


def _conv(x, w, cast, **kw):
    return F.conv2d(x, w, **kw) if cast is None else F.conv2d(cast(x), cast(w), **kw)


def _bn(x, sd, p, pending):
    y = F.batch_norm(x, None, None, sd[f"{p}.weight"], sd[f"{p}.bias"], True, 0.0, 1e-5)
    if pending is not None:
        with torch.no_grad():
            pending[p] = (x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), unbiased=False))
    return y


def encoder_forward(sd, x_nhwc, size: int, stages=(3, 4, 23, 3), pending: dict | None = None, cast=None):
    """NHWC images -> (B, size, size, 2048) features (ResNet-101's stages
    by default); each BN's batch mean and biased variance into
    ``pending``.  ``cast`` rounds every conv's input and weight (the
    control's lower precision)."""
    x = x_nhwc.permute(0, 3, 1, 2)
    x = F.relu(_bn(_conv(x, sd["conv1.weight"], cast, stride=2, padding=3), sd, "bn1", pending))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for s, blocks in enumerate(stages):
        for b in range(blocks):
            p = f"layer{s + 1}.{b}"
            stride = 2 if (s > 0 and b == 0) else 1
            res = x
            if b == 0:
                res = _bn(_conv(x, sd[f"{p}.downsample.0.weight"], cast, stride=stride), sd,
                          f"{p}.downsample.1", pending)
            y = F.relu(_bn(_conv(x, sd[f"{p}.conv1.weight"], cast), sd, f"{p}.bn1", pending))
            y = F.relu(_bn(_conv(y, sd[f"{p}.conv2.weight"], cast, stride=stride, padding=1), sd, f"{p}.bn2",
                           pending))
            y = _bn(_conv(y, sd[f"{p}.conv3.weight"], cast), sd, f"{p}.bn3", pending)
            x = F.relu(y + res)
    return F.adaptive_avg_pool2d(x, size).permute(0, 2, 3, 1)


def _lin(x, sd, p):
    return F.linear(x, sd[f"{p}.weight"], sd[f"{p}.bias"])


def decoder_forward(sd, enc_out, captions, lengths, generator, p_drop: float, steps: int | None = None):
    """Teacher-forced decode over the padded captions: (predictions
    (B, L-1, V) zero past each caption, alphas (B, L-1, P), decode
    lengths).  The loop runs to the longest caption (``steps``, where
    the lengths are not readable, as on meta tensors)."""
    b = enc_out.shape[0]
    enc = enc_out.reshape(b, -1, enc_out.shape[-1])
    dec_len = lengths - 1
    max_t = captions.shape[1] - 1
    steps = min(max_t, int(dec_len.max()) if steps is None else steps)
    emb = sd["embedding.weight"][captions]
    mean = enc.mean(dim=1)
    h, c = _lin(mean, sd, "init_h"), _lin(mean, sd, "init_c")
    enc_proj = _lin(enc, sd, "attention.encoder_att")
    hs, alphas = [], []
    for t in range(steps):
        active = (t < dec_len)[:, None].to(enc.dtype)
        e = F.relu(enc_proj + _lin(h, sd, "attention.decoder_att")[:, None])
        alpha = torch.softmax(_lin(e, sd, "attention.full_att")[..., 0], dim=-1)
        ctx = torch.bmm(alpha[:, None], enc)[:, 0]
        gate = torch.sigmoid(_lin(h, sd, "f_beta"))
        x = torch.cat([emb[:, t], gate * ctx], dim=-1)
        gates = (F.linear(x, sd["decode_step.weight_ih"], sd["decode_step.bias_ih"])
                 + F.linear(h, sd["decode_step.weight_hh"], sd["decode_step.bias_hh"]))
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        h = active * h_new + (1 - active) * h
        c = active * c_new + (1 - active) * c
        hs.append(h_new)
        alphas.append(alpha * active)
    for _ in range(max_t - steps):
        hs.append(torch.zeros_like(h))
        alphas.append(enc.new_zeros(b, enc.shape[1]))
    hs_t = torch.stack(hs, dim=1)
    if p_drop > 0:
        keep = 1.0 - p_drop
        # Drawn in float32 whatever the decoder's dtype: the same mask on both sides.
        mask = torch.rand(hs_t.shape, generator=generator, device=hs_t.device, dtype=torch.float32) < keep
        hs_t = torch.where(mask, hs_t / keep, torch.zeros((), dtype=hs_t.dtype, device=hs_t.device))
    preds = _lin(hs_t, sd, "fc")
    valid = (torch.arange(max_t, device=enc.device)[None] < dec_len[:, None]).to(preds.dtype)
    return preds * valid[..., None], torch.stack(alphas, dim=1), dec_len


def step_loss(states, cfg, batch, generator, pending=None, steps=None, cast=None, rows=None, dec_dtype=None):
    """The step's loss (a scalar with its graph) and its cross-entropy.
    ``cast``: see :func:`encoder_forward`; ``rows``: the cross-entropy
    over the first ``rows`` captions only (a planted fault);
    ``dec_dtype``: the decoder, its cross-entropy and attention term in
    that dtype (the decoder's lower-precision control)."""
    cap, lens = cfg["caption"], cfg["lens"]
    cam = states["camera"]
    coeffs = torch.cat([cam["zernike_coeffs_no_train"].reshape(-1), cam["zernike_coeffs_train"].reshape(-1),
                        cam["zernike_coeffs_no_train2"].reshape(-1)])
    n = lens["wave_res"]
    noise = torch.rand((n, n), generator=generator, device=coeffs.device, dtype=torch.float32) \
        if generator is not None else None
    images = batch["images"]
    if coeffs.device.type == "meta":
        psf_loss = coeffs.sum()
        sensor = images
    else:
        psf, psf_loss = optics.lens_psf(coeffs, lens, noise)
        sensor = optics.lens_sensor(images, psf)
    feats = encoder_forward(states["encoder"], sensor.float(), cap["encoded_image_size"],
                            cfg["encoder"]["stages"], pending, cast)
    dec = states["decoder"]
    if dec_dtype is not None:
        dec, feats = {k: v.to(dec_dtype) if v.is_floating_point() else v for k, v in dec.items()}, feats.to(dec_dtype)
    preds, alphas, dec_len = decoder_forward(dec, feats, batch["captions"], batch["caption_lengths"], generator,
                                             cap["dropout"], steps)
    targets = batch["captions"][:, 1:]
    if rows is not None:
        preds, targets, dec_len = preds[:rows], targets[:rows], dec_len[:rows]
    valid = (torch.arange(preds.shape[1], device=preds.device)[None] < dec_len[:, None]).to(preds.dtype)
    logp = torch.log_softmax(preds, dim=-1).gather(-1, targets[..., None])[..., 0]
    ce = -(logp * valid).sum() / valid.sum().clamp_min(1.0)
    dsr = torch.mean((1.0 - alphas.sum(dim=1)) ** 2)
    ce, dsr = ce.float(), dsr.float()
    cam_term = 1.0 - torch.mean((images.double() - sensor) ** 2)
    loss = cap["w_caption"] * (ce + cap["alpha_c"] * dsr) + cap["w_ssim"] * cam_term + cap["w_psf"] * psf_loss
    return loss, ce


def _adam(p, g, m, v, t, lr, b1=0.9, b2=0.999, eps=1e-8):
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    denom = (v.sqrt() / (1 - b2**t) ** 0.5).add_(eps)
    p.addcdiv_(m, denom, value=-lr / (1 - b1**t))


def train_steps(states, cfg, batches, generator, cast=None, rows=None, dec_dtype=None):
    """Run ``len(batches)`` steps from ``states`` (copied, not changed).
    Returns (the steps' losses, {(module, name): first applied gradient},
    the state after the last step, the encoder's batch-norm statistics
    after the first, the steps' cross-entropies).  ``cast``, ``rows``
    and ``dec_dtype`` as in :func:`step_loss`."""
    cap = cfg["caption"]
    lrs = {"camera": cap["camera_lr"], "encoder": cap["encoder_lr"], "decoder": cap["decoder_lr"]}
    st = {m: {k: v.detach().clone().float() for k, v in sd.items()} for m, sd in states.items()}
    leaves = [(m, k) for m in ("camera", "encoder", "decoder") for k in st[m] if trainable(m, k)]
    adam = {key: (torch.zeros_like(st[key[0]][key[1]]), torch.zeros_like(st[key[0]][key[1]])) for key in leaves}
    losses, ces, first = [], [], {}
    for t, batch in enumerate(batches, start=1):
        for key in leaves:
            st[key[0]][key[1]].requires_grad_(True)
        pending: dict = {}
        with torch.enable_grad():
            loss, ce = step_loss(st, cfg, batch, generator, pending, cast=cast, rows=rows, dec_dtype=dec_dtype)
            grads = torch.autograd.grad(loss, [st[m][k] for m, k in leaves])
        losses.append(float(loss.detach()))
        ces.append(float(ce.detach()))
        with torch.no_grad():
            for (m, k), g in zip(leaves, grads):
                p = st[m][k].detach_()
                if m != "camera":
                    g = g.clamp(-cap["grad_clip"], cap["grad_clip"])
                if t == 1:
                    first[(m, k)] = g.clone()
                _adam(p, g, *adam[(m, k)], t, lrs[m])
            enc = st["encoder"]
            for p, (mean, var) in pending.items():
                enc[f"{p}.running_mean"].mul_(0.9).add_(0.1 * mean)
                enc[f"{p}.running_var"].mul_(0.9).add_(0.1 * var)
            if t == 1:
                bn1 = {k: v.clone() for k, v in enc.items() if k.endswith(("running_mean", "running_var"))}
    return losses, first, st, bn1, ces
