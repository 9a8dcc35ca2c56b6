"""Plain Face-DeId GAN training iteration, float32 with the optics in
float64, over state dicts.

Written from Face-DeId/core/solver.py:107-248 (the iteration), :292-312
(R1 and the fake branch), :322-364 (the generator loss) and main.py:86-198
(the recipe) of carlosh93/privacy-preserving-vision, with the networks of
core/model.py (discriminator, mapping network), core/wing.py (FAN),
metrics/lpips.py (LPIPS on AlexNet) and RAFT/core (feature and context
encoders, the all-pairs correlation pyramid, the SepConvGRU update and
convex upsampling), under the state-dict names they use.  The generator,
the style encoder, the FAN trunk and the camera are those of
:mod:`.deid`.  One iteration:

1. the frozen camera forms the private image, the frozen privacy FAN
   its two masks, the clean FAN the flow loss's face mask;
2. a discriminator step on latent-style fakes with R1 on the real
   references (a gradient of a gradient), then one on reference-style
   fakes;
3. a generator step from latent styles (G, the mapping network and the
   style encoder) with the RAFT flow loss and the value-only heatmap
   L1, then one from reference styles (G alone) with LPIPS x 2000 and
   the flow loss;
4. Adam (weight decay added to the gradient before the moments, as
   ``torch.optim.Adam(weight_decay=)`` in solver.py:60-67) for each net
   a sub-step updates, and the EMA of G, the mapping network and the
   style encoder as ``p + beta * (e - p)``.

Departures from solver.py, each as the port has it: the FAN runs at the
configuration's ``fan_input_size`` (256 in the recipe, the resolution
solver.py's FAN sees); the cycle branch's FAN call whose masks are
discarded (solver.py:355-357) is not run; LPIPS compares the batch's
reference images with the fakes; the flow loss's frames are the source
and the fake, x 255, times the clean FAN's jaw-less heatmap above 0.5.
No pretrained file is read: every net takes the benchmark's seeded
weights.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from . import deid, optics

__all__ = ["NETS", "EMA_NETS", "SUBSTEPS", "generator", "mapping", "discriminate", "privacy_masks", "heatmaps",
           "lpips", "raft_flow", "flow_loss", "lowered", "train_steps", "counted_step"]

NETS = ("generator", "mapping_network", "style_encoder", "discriminator")
EMA_NETS = ("generator", "mapping_network", "style_encoder")
# Each sub-step of an iteration and the nets it updates, in order.
SUBSTEPS = (("D/latent", ("discriminator",)), ("D/ref", ("discriminator",)),
            ("G/latent", ("generator", "mapping_network", "style_encoder")), ("G/ref", ("generator",)))
# FAN's facial-part channel ranges (wing.py:518-528).
PARTS = dict(chin=(8, 25), eyebrows=(33, 51), eyebrowsedges=(33, 46), nose=(51, 55), nostrils=(55, 60),
             eyes=(60, 76), lipedges=(76, 82), lipupper=(77, 82), liplower=(83, 88), lipinner=(88, 96))
# LPIPS's input scaling (the [-1, 1]-range ImageNet statistics).
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)


@contextlib.contextmanager
def lowered(cast):
    """Inside, every ``F.conv2d`` call takes its input and weight through
    ``cast`` (a rounding whose gradient passes straight through), the
    lower-precision control's convs; ``None`` changes nothing."""
    if cast is None:
        yield
        return
    real = F.conv2d

    def conv2d(x, w, *args, **kw):
        return real(cast(x), cast(w), *args, **kw)

    F.conv2d = conv2d
    try:
        yield
    finally:
        F.conv2d = real


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


# --- StarGAN-v2 nets (model.py) ---------------------------------------------


def generator(sd, model, x, s, masks):
    """G(x, s, masks), NCHW; without masks no high-pass skips (the cycle
    branch)."""
    if masks is None:
        rn = deid._repeat_num(model)
        z = deid._conv(x, sd, "from_rgb", padding=1)
        for i in range(rn + 2):
            z = deid._resblk(z, sd, f"encode.{i}", normalize=True, downsample=i < rn)
        hps = {}
    else:
        z, hps = deid.encode(sd, model, x, masks)
    return deid.decode(sd, model, z, s, hps)


def mapping(sd, model, z, y):
    """MappingNetwork: latents, integer domains -> (B, style_dim)."""
    h = z
    for i in range(0, 8, 2):
        h = F.relu(F.linear(h, sd[f"shared.{i}.weight"], sd[f"shared.{i}.bias"]))
    outs = []
    for d in range(model["num_domains"]):
        u = h
        for i in range(0, 6, 2):
            u = F.relu(F.linear(u, sd[f"unshared.{d}.{i}.weight"], sd[f"unshared.{d}.{i}.bias"]))
        outs.append(F.linear(u, sd[f"unshared.{d}.6.weight"], sd[f"unshared.{d}.6.bias"]))
    return torch.stack(outs, dim=1)[torch.arange(z.shape[0], device=z.device), y]


def discriminate(sd, model, x, y):
    """Discriminator: NCHW images, integer domains -> (B,) logits (the
    style encoder's trunk under ``main``, then a 1x1 conv per domain)."""
    repeat = int(math.log2(model["img_size"])) - 2
    h = deid._conv(x, sd, "main.0", padding=1)
    for i in range(repeat):
        h = deid._resblk(h, sd, f"main.{i + 1}", normalize=False, downsample=True)
    h = _lrelu(deid._conv(_lrelu(h), sd, f"main.{repeat + 2}"))
    out = deid._conv(h, sd, f"main.{repeat + 4}").reshape(x.shape[0], -1)
    return out[torch.arange(x.shape[0], device=x.device), y]


def adv_loss(logits, target: int):
    """BCE with logits against a constant target (solver.py:372-376)."""
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, float(target)))


# --- FAN heatmaps (wing.py:241-260, 532-578) --------------------------------


def _fan_out(sd, x_nhwc, size: int):
    x = x_nhwc.permute(0, 3, 1, 2)
    if x.shape[-1] != size:
        x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False)
    return deid.fan_heatmaps(sd, x * 0.5 + 0.5)


def privacy_masks(sd, x_nhwc, size: int, landmarks: int = 98):
    """The two privacy masks, (B, 1, size, size) each: the landmark
    heatmaps upsampled (corners aligned), summed over each half of the
    landmarks, clamped to [0, 1]."""
    hm = F.interpolate(_fan_out(sd, x_nhwc, size)[:, :landmarks], size=(size, size), mode="bilinear",
                       align_corners=True)
    half = landmarks // 2
    return hm[:, :half].sum(1, keepdim=True).clamp(0, 1), hm[:, half:].sum(1, keepdim=True).clamp(0, 1)


def _shift(x, n: int):
    """wing.py's ``shift``: a circular roll of the rows (NCHW)."""
    return torch.roll(x, -n, dims=2)


def heatmaps(sd, x_nhwc, size: int, delimiter: bool = False):
    """The facial-part masks of ``preprocess`` (wing.py:532-578) over the
    98 landmarks, (B, 1, size, size) each; ``delimiter`` zeroes the 33
    jaw channels first."""
    hm = F.interpolate(_fan_out(sd, x_nhwc, size)[:, :98], size=(size, size), mode="bilinear",
                       align_corners=True)
    if delimiter:
        hm = torch.cat([torch.zeros_like(hm[:, :33]), hm[:, 33:]], dim=1)
    sw = size // 256
    chans = list(hm.unbind(1))
    for name, n, power in (("chin", 0, 3), ("eyebrows", -7 * sw, 2), ("nostrils", 8 * sw, 4),
                           ("lipupper", -8 * sw, 4), ("liplower", 8 * sw, 4), ("lipinner", -2 * sw, 3)):
        s, e = PARTS[name]
        block = _shift(torch.stack(chans[s:e], 1), n) ** power
        chans[s:e] = block.unbind(1)
    zero = [*range(0, PARTS["chin"][0]), *range(PARTS["chin"][1], 33), PARTS["eyebrowsedges"][0],
            PARTS["eyebrowsedges"][1], PARTS["lipedges"][0], PARTS["lipedges"][1]]
    for c in zero:
        chans[c] = torch.zeros_like(chans[c])
    s, e = PARTS["nose"]
    chans[s + 1:e] = _shift(torch.stack(chans[s + 1:e], 1), 4 * sw).unbind(1)
    s, e = PARTS["eyes"]
    eyes = torch.stack(chans[s:e], 1)
    chans[s:e] = (_shift(eyes, -8) ** 3 + _shift(eyes, -24)).unbind(1)
    m1 = torch.stack(chans, 1)
    drop = {*range(*PARTS["chin"]), *range(PARTS["lipedges"][0], PARTS["lipinner"][1]), *range(*PARTS["eyebrows"])}
    m2 = torch.stack([torch.zeros_like(c) if i in drop else c for i, c in enumerate(chans)], 1)
    m1 = torch.nan_to_num(m1.sum(1, keepdim=True))
    m2 = torch.nan_to_num(m2.sum(1, keepdim=True))
    return m1.clamp(0, 1), m2.clamp(0, 1)


# --- LPIPS (metrics/lpips.py) -----------------------------------------------


def _alex(sd, x):
    """AlexNet's five post-ReLU maps of NCHW ``x``, each normalized over
    its channels."""
    out = []
    for i, (idx, stride, pad, pool) in enumerate(((0, 4, 2, True), (3, 1, 2, True), (6, 1, 1, False),
                                                  (8, 1, 1, False), (10, 1, 1, False))):
        x = F.relu(F.conv2d(x, sd[f"alexnet.layers.{idx}.weight"], sd[f"alexnet.layers.{idx}.bias"], stride, pad))
        out.append(x * torch.rsqrt(torch.sum(x * x, dim=1, keepdim=True) + 1e-10))
        if pool:
            x = F.max_pool2d(x, 3, 2)
    return out


def lpips(sd, x_nhwc, y_nhwc):
    """The LPIPS distance of two NHWC batches: per layer the squared
    difference of the normalized maps weighted by its 1x1 head, averaged
    over batch and pixels; summed over the five layers."""
    shift = torch.tensor(LPIPS_SHIFT, dtype=x_nhwc.dtype, device=x_nhwc.device)
    scale = torch.tensor(LPIPS_SCALE, dtype=x_nhwc.dtype, device=x_nhwc.device)
    fa = _alex(sd, ((x_nhwc - shift) / scale).permute(0, 3, 1, 2))
    fb = _alex(sd, ((y_nhwc - shift) / scale).permute(0, 3, 1, 2))
    return sum(F.conv2d((a - b) ** 2, sd[f"lpips_weights.{i}.main.1.weight"]).mean()
               for i, (a, b) in enumerate(zip(fa, fb)))


# --- RAFT (RAFT/core) ---------------------------------------------------------


def _rconv(x, sd, p, stride=1, padding=0):
    return F.conv2d(x, sd[f"{p}.weight"], sd[f"{p}.bias"], stride, padding)


def _norm(x, sd, p):
    """Instance norm (no state) where the state dict has no such entry,
    else batch norm at its running statistics."""
    if f"{p}.running_mean" not in sd:
        return F.instance_norm(x, eps=1e-5)
    return F.batch_norm(x, sd[f"{p}.running_mean"], sd[f"{p}.running_var"], sd[f"{p}.weight"], sd[f"{p}.bias"],
                        False, 0.0, 1e-5)


def _residual(x, sd, p, stride):
    y = F.relu(_norm(_rconv(x, sd, f"{p}.conv1", stride, 1), sd, f"{p}.norm1"))
    y = F.relu(_norm(_rconv(y, sd, f"{p}.conv2", 1, 1), sd, f"{p}.norm2"))
    if f"{p}.downsample.0.weight" in sd:
        x = _norm(_rconv(x, sd, f"{p}.downsample.0", stride), sd, f"{p}.downsample.1")
    return F.relu(x + y)


def _encoder(x, sd, p):
    """BasicEncoder (extractor.py:118-192) at 1/8 resolution."""
    x = F.relu(_norm(_rconv(x, sd, f"{p}.conv1", 2, 3), sd, f"{p}.norm1"))
    for layer, stride in ((1, 1), (2, 2), (3, 2)):
        x = _residual(x, sd, f"{p}.layer{layer}.0", stride)
        x = _residual(x, sd, f"{p}.layer{layer}.1", 1)
    return _rconv(x, sd, f"{p}.conv2")


def _corr_pyramid(f1, f2, levels: int):
    """All-pairs correlation (B*H*W, 1, H, W) and its 2x average pools."""
    b, c, h, w = f1.shape
    corr = torch.einsum("bci,bcj->bij", f1.reshape(b, c, h * w), f2.reshape(b, c, h * w)) / math.sqrt(c)
    pyr = [corr.reshape(b * h * w, 1, h, w)]
    for _ in range(levels - 1):
        pyr.append(F.avg_pool2d(pyr[-1], 2, stride=2))
    return pyr


def _lookup(pyr, coords, radius: int):
    """Bilinear samples of every level in a (2r+1)^2 window around each
    query's coordinates (corners aligned, zeros outside), x-major:
    (B, L*(2r+1)^2, H, W)."""
    b, h, w, _ = coords.shape
    d = torch.linspace(-radius, radius, 2 * radius + 1, device=coords.device)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)  # [i, j] = (d[i], d[j]) added to (x, y)
    out = []
    for i, corr in enumerate(pyr):
        hl, wl = corr.shape[-2:]
        at = coords.reshape(b * h * w, 1, 1, 2) / 2**i + delta[None]
        grid = torch.stack([2 * at[..., 0] / (wl - 1) - 1, 2 * at[..., 1] / (hl - 1) - 1], dim=-1)
        out.append(F.grid_sample(corr, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
                   .reshape(b, h, w, -1))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2)


def _gru(h, x, sd):
    p = "update_block.gru"
    for tag, pad in (("1", (0, 2)), ("2", (2, 0))):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(_rconv(hx, sd, f"{p}.convz{tag}", padding=pad))
        r = torch.sigmoid(_rconv(hx, sd, f"{p}.convr{tag}", padding=pad))
        q = torch.tanh(_rconv(torch.cat([r * h, x], dim=1), sd, f"{p}.convq{tag}", padding=pad))
        h = (1 - z) * h + z * q
    return h


def _update(net, inp, corr, flow, sd):
    """BasicUpdateBlock (update.py): motion encoder, SepConvGRU, flow head
    and the convex-upsampling mask (x 0.25)."""
    p = "update_block.encoder"
    cor = F.relu(_rconv(F.relu(_rconv(corr, sd, f"{p}.convc1")), sd, f"{p}.convc2", padding=1))
    flo = F.relu(_rconv(F.relu(_rconv(flow, sd, f"{p}.convf1", padding=3)), sd, f"{p}.convf2", padding=1))
    motion = torch.cat([F.relu(_rconv(torch.cat([cor, flo], 1), sd, f"{p}.conv", padding=1)), flow], dim=1)
    net = _gru(net, torch.cat([inp, motion], dim=1), sd)
    mask = 0.25 * _rconv(F.relu(_rconv(net, sd, "update_block.mask.0", padding=1)), sd, "update_block.mask.2")
    delta = _rconv(F.relu(_rconv(net, sd, "update_block.flow_head.conv1", padding=1)), sd,
                   "update_block.flow_head.conv2", padding=1)
    return net, mask, delta


def _upsample(flow, mask):
    """Convex 8x upsampling (raft.py:74-85)."""
    b, _, h, w = flow.shape
    mask = torch.softmax(mask.reshape(b, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).reshape(b, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(b, 2, 8 * h, 8 * w)


def raft_flow(sd, raft: dict, img1, img2, iters: int):
    """RAFT's final flow (B, 2, H, W) between NHWC frames in [0, 255],
    the dense correlation pyramid, coordinates detached at each
    refinement step (raft.py:87-144)."""
    x1 = (2 * (img1 / 255.0) - 1).permute(0, 3, 1, 2)
    x2 = (2 * (img2 / 255.0) - 1).permute(0, 3, 1, 2)
    f1, f2 = _encoder(torch.cat([x1, x2]), sd, "fnet").chunk(2)
    pyr = _corr_pyramid(f1, f2, raft["corr_levels"])
    ctx = _encoder(x1, sd, "cnet")
    net, inp = torch.tanh(ctx[:, :raft["hidden_dim"]]), F.relu(ctx[:, raft["hidden_dim"]:])
    b, _, h, w = f1.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=f1.device), torch.arange(w, device=f1.device), indexing="ij")
    coords0 = torch.stack([xs, ys], -1).to(f1.dtype)[None].expand(b, h, w, 2)
    coords1 = coords0
    mask = None
    for _ in range(iters):
        coords1 = coords1.detach()
        corr = _lookup(pyr, coords1, raft["corr_radius"])
        net, mask, delta = _update(net, inp, corr, (coords1 - coords0).permute(0, 3, 1, 2), sd)
        coords1 = coords1 + delta.permute(0, 2, 3, 1)
    return _upsample((coords1 - coords0).permute(0, 3, 1, 2), mask)


def flow_loss(sd, raft: dict, img1, img2, iters: int):
    """loss_RAFT (utils.py:460-462): the batch's sum of |mean flow|."""
    return torch.abs(raft_flow(sd, raft, img1, img2, iters).mean(dim=(1, 2, 3))).sum()


# --- the iteration --------------------------------------------------------------


def _front(states, cfg, batch, psf):
    """Private images (NCHW), privacy masks and the flow loss's face mask
    (NHWC), all without gradients."""
    model, size = cfg["model"], cfg["model"]["fan_input_size"]
    x_src = batch["x_src"]
    with torch.no_grad():
        sensor = x_src if psf is None else optics.camera_sensor(x_src, psf).float()
        masks = privacy_masks(states["fan_priv"], sensor, size, cfg["fan"]["num_landmarks"])
        hm = heatmaps(states["fan"], x_src, size, delimiter=True)[0]
        if hm.shape[-1] != model["img_size"]:
            hm = F.interpolate(hm, size=(model["img_size"],) * 2, mode="bilinear", align_corners=False)
        mask_org = (hm > 0.5).to(x_src.dtype).permute(0, 2, 3, 1)
    return sensor.permute(0, 3, 1, 2), masks, mask_org


def _losses(st, states, cfg, batch, front, sub, lam_ds, fault=None):
    """Sub-step ``sub``'s loss (a scalar with its graph), its terms, and
    the part of the loss a fault would take out (R1's term in a
    discriminator sub-step, the flow term in a generator one; None
    without a flow loss)."""
    model, lc, tr = cfg["model"], cfg["loss"], cfg["train"]
    x_real, masks, mask_org = front
    x_src = batch["x_src"]
    x_ref, x_ref2 = batch["x_ref"].permute(0, 3, 1, 2), batch["x_ref2"].permute(0, 3, 1, 2)
    y_src, y_trg = batch["y_src"].long(), batch["y_ref"].long()
    G, M, S, D = (st[k] for k in NETS)
    tag = sub.split("/")[1]
    if sub.startswith("D/"):
        with torch.no_grad():
            style = mapping(M, model, batch["z_trg"], y_trg) if tag == "latent" else \
                deid.style_codes(S, model, x_ref, y_trg)
        x = x_ref.detach().requires_grad_(True)
        out = discriminate(D, model, x, y_trg)
        real = adv_loss(out, 1)
        (gx,) = torch.autograd.grad(out.sum(), x, create_graph=True)
        reg = 0.5 * torch.mean(torch.sum(gx ** 2, dim=(1, 2, 3)))
        with torch.no_grad():
            x_fake = generator(G, model, x_real, style, masks)
        fake = adv_loss(discriminate(D, model, x_fake, y_trg), 0)
        part = lc["lambda_reg"] * reg
        loss = real + fake + (0.0 if fault == "no_r1" else part)
        return loss, {f"{sub}_real": real, f"{sub}_fake": fake, f"{sub}_reg": reg}, part
    if tag == "latent":
        s_trg = mapping(M, model, batch["z_trg"], y_trg)
        with torch.no_grad():
            s_trg2 = mapping(M, model, batch["z_trg2"], y_trg)
        s_org = deid.style_codes(S, model, x_real, y_src)
    else:
        with torch.no_grad():
            s_trg, s_trg2 = deid.style_codes(S, model, x_ref, y_trg), deid.style_codes(S, model, x_ref2, y_trg)
            s_org = deid.style_codes(S, model, x_real, y_src)
    x_fake = generator(G, model, x_real, s_trg, masks)
    terms = {"adv": adv_loss(discriminate(D, model, x_fake, y_trg), 1),
             "sty": lc["lambda_sty"] * torch.mean(torch.abs(deid.style_codes(S, model, x_fake, y_trg) - s_trg))}
    with torch.no_grad():
        x_fake2 = generator(G, model, x_real, s_trg2, masks)
    terms["ds"] = lam_ds * torch.mean(torch.abs(x_fake - x_fake2))
    terms["cyc"] = lc["lambda_cyc"] * torch.mean(torch.abs(generator(G, model, x_fake, s_org, None) - x_real))
    loss = terms["adv"] + terms["sty"] - terms["ds"] + terms["cyc"]
    fake_hwc = x_fake.permute(0, 2, 3, 1)
    if tag == "ref" and tr["use_lpips"]:
        terms["lpips"] = torch.abs(lpips(states["lpips"], batch["x_ref"], fake_hwc)) * lc["lambda_lpips"]
        loss = loss + terms["lpips"]
    if tr["use_flow"]:
        frames = fake_hwc.detach() if fault == "flow_detached" else fake_hwc
        terms["flow"] = flow_loss(states["raft"], cfg["raft"], x_src * mask_org * 255.0, frames * mask_org * 255.0,
                                  tr["flow_iters"]) * lc["lambda_flow"]
        loss = loss + terms["flow"]
    if tag == "latent" and lc["lambda_heatmap"]:
        with torch.no_grad():
            mf = heatmaps(states["fan"], fake_hwc, model["fan_input_size"])[0]
            terms["heatmap_l1"] = torch.mean(torch.abs(mf - masks[0])) * lc["lambda_heatmap"]
        loss = loss + terms["heatmap_l1"]
    return loss, {f"{sub}_{k}": v for k, v in terms.items()}, terms.get("flow")


def _first_half(x):
    """The first half of the rows of a tensor, or of each tensor in a
    dict or tuple."""
    if isinstance(x, dict):
        return {k: _first_half(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_first_half(v) for v in x)
    return x[: x.shape[0] // 2]


def _adam(p, g, m, v, t, lr, b1, b2, wd, eps=1e-8):
    g = g + wd * p
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    p.addcdiv_(m, v.sqrt() / math.sqrt(1 - b2**t) + eps, value=-lr / (1 - b1**t))


def train_steps(states, cfg, batches, cast=None, fault=None, follow=None, parts: bool = False) -> dict:
    """Run ``len(batches)`` iterations from ``states`` (copied, not
    changed).  Returns ``losses`` ([{term: float}] an iteration, the
    port's metric names), ``grads`` ([{sub-step: {(net, name): tensor}}],
    each sub-step's gradient before its update), ``after`` and ``ema``
    ({net: state dict} after the last iteration).

    ``follow``: gradients of the same form to apply in place of this
    run's own, so that each of its sub-steps computes its gradient at
    the weights the run that gave them had.  ``parts``: also return
    ``part_grads``, each sub-step's gradient of the part of its loss a
    fault would take out (R1's term, the flow term).  ``cast``: every conv in
    that rounding (the control).  ``fault``: ``no_r1`` (R1 left out of
    the discriminator's loss), ``flow_detached`` (the flow term's
    gradient cut), ``g_half_batch`` (both generator sub-steps' losses,
    and so their gradients, over the first half of the batch),
    ``no_ema`` (the EMA left as it was)."""
    tr, model = cfg["train"], cfg["model"]
    st = {k: {n: t.detach().clone().float() for n, t in states[k].items()} for k in NETS}
    ema = {k: {n: t.clone() for n, t in st[k].items()} for k in EMA_NETS}
    moments = {(k, n): (torch.zeros_like(t), torch.zeros_like(t), [0]) for k in NETS for n, t in st[k].items()}
    frozen = {k: {n: t.float() for n, t in sd.items()} for k, sd in states.items() if k not in NETS}
    cam = states["camera"]
    dev = batches[0]["x_src"].device
    coeffs = torch.cat([cam["Zer_no_train"].reshape(-1), cam["Zer_train"].reshape(-1)]).double().cpu().numpy()
    psf = optics.camera_psf(coeffs, cfg["camera"], dev)
    out = {"losses": [], "grads": [], "part_grads": []}
    with lowered(cast):
        for t, batch in enumerate(batches):
            lam_ds = cfg["loss"]["lambda_ds"] * min(max(1.0 - t / cfg["loss"]["ds_iter"], 0.0), 1.0)
            front = _front(frozen, cfg, batch, psf)
            terms, grads, part_grads = {}, {}, {}
            for sub, names in SUBSTEPS:
                keys = [(k, n) for k in names for n in st[k]]
                for k, n in keys:
                    st[k][n].requires_grad_(True)
                half = fault == "g_half_batch" and sub.startswith("G/")
                b, f = (_first_half(batch), _first_half(front)) if half else (batch, front)
                with torch.enable_grad():
                    loss, named, part = _losses(st, frozen, cfg, b, f, sub, lam_ds, fault)
                    leaves = [st[k][n] for k, n in keys]
                    if parts and part is not None:
                        gp = torch.autograd.grad(part, leaves, retain_graph=True, allow_unused=True)
                        part_grads[sub] = {key: torch.zeros_like(st[key[0]][key[1]]) if gi is None else gi
                                           for key, gi in zip(keys, gp)}
                    g = torch.autograd.grad(loss, leaves, allow_unused=True)
                terms.update({name: float(v.detach()) for name, v in named.items()})
                grads[sub] = {key: torch.zeros_like(st[key[0]][key[1]]) if gi is None else gi.detach()
                              for key, gi in zip(keys, g)}
                applied = grads[sub] if follow is None else {**grads[sub], **follow[t].get(sub, {})}
                with torch.no_grad():
                    for k, n in keys:
                        p = st[k][n].detach_()
                        m, v, count = moments[(k, n)]
                        count[0] += 1
                        lr = tr["f_lr"] if k == "mapping_network" else tr["lr"]
                        _adam(p, applied[(k, n)].float(), m, v, count[0], lr, tr["beta1"], tr["beta2"],
                              tr["weight_decay"])
            if fault != "no_ema":
                with torch.no_grad():
                    for k in EMA_NETS:
                        for n, e in ema[k].items():
                            e.copy_(st[k][n] + tr["ema_beta"] * (e - st[k][n]))
            terms["G/lambda_ds"] = lam_ds
            out["losses"].append(terms)
            out["grads"].append(grads)
            out["part_grads"].append(part_grads)
    out["after"], out["ema"] = st, ema
    return out


def counted_step(states, cfg, b: int):
    """One iteration's forward and backward passes on ``meta`` tensors of
    a batch of ``b`` (the FLOP count; the camera's FFTs, the optimizers
    and the EMA are not counted)."""
    n, latent = cfg["model"]["img_size"], cfg["model"]["latent_dim"]
    meta = {k: {name: torch.empty(t.shape, device="meta") for name, t in sd.items() if t.is_floating_point()}
            for k, sd in states.items()}
    img = lambda: torch.empty((b, n, n, 3), device="meta")  # noqa: E731
    y = torch.zeros(b, dtype=torch.long, device="meta")
    batch = dict(x_src=img(), x_ref=img(), x_ref2=img(), y_src=y, y_ref=y,
                 z_trg=torch.empty((b, latent), device="meta"), z_trg2=torch.empty((b, latent), device="meta"))
    front = _front(meta, cfg, batch, None)
    for sub, names in SUBSTEPS:
        leaves = [meta[k][name].requires_grad_(True) for k in names for name in meta[k]]
        with torch.enable_grad():
            loss, _, _ = _losses(meta, meta, cfg, batch, front, sub, 1.0)
            torch.autograd.grad(loss, leaves, allow_unused=True)
        for t in leaves:
            t.requires_grad_(False)
