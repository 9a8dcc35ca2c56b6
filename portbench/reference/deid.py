"""Plain Face-DeId de-identification: camera -> FAN privacy masks ->
StarGAN-v2 generator, in float32 NCHW over state dicts.

Written from the published networks (Face-DeId/core/model.py and
core/wing.py of carlosh93/privacy-preserving-vision) with the state-dict
names they use: the generator's skip features are centred on their mean
over the whole batch before the masked high-pass, the decoder's blocks
at w_hpf > 0 return their residual branch alone, the FAN is the
single-stack CoordConv hourglass whose 98 landmark heatmaps are summed
into two clamped privacy masks.  Every 3x3 conv and every
instance-norm moment notes its shape on :mod:`.tape`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import optics, tape

__all__ = ["privacy_front", "style_codes", "generate", "deid_batch", "to_uint8", "counted_batch"]


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _conv(x, sd, name, stride=1, padding=0):
    return F.conv2d(x, sd[f"{name}.weight"], sd.get(f"{name}.bias"), stride, padding)


def _conv3x3(x, sd, name):
    """A stride-1 SAME 3x3 conv on an un-resampled input."""
    w = sd[f"{name}.weight"]
    if x.shape[1] % 16 == 0 and w.shape[0] % 16 == 0:
        tape.note("conv3x3", x.shape[0], x.shape[2], x.shape[3], x.shape[1], w.shape[0])
    return F.conv2d(x, w, sd.get(f"{name}.bias"), 1, 1)


def _conv3x3_up(x, sd, name):
    """Nearest 2x upsample, then a SAME 3x3 conv.  On ``meta`` tensors
    (the FLOP count) the same map is taken as the 4x4 stride-2
    transposed conv on the low-resolution side, the work it needs."""
    w, b = sd[f"{name}.weight"], sd[f"{name}.bias"]
    if tape.counting():
        return F.conv_transpose2d(x, w.new_empty(w.shape[1], w.shape[0], 4, 4), b, stride=2, padding=1)
    return F.conv2d(F.interpolate(x, scale_factor=2, mode="nearest"), w, b, 1, 1)


def _conv3x3_pool(x, sd, name):
    """A SAME 3x3 conv, then a 2x2 mean pool (counted as the 4x4 stride-2
    conv it equals)."""
    w, b = sd[f"{name}.weight"], sd.get(f"{name}.bias")
    if tape.counting():
        return F.conv2d(x, w.new_empty(w.shape[0], w.shape[1], 4, 4), b, 2, 1)
    return F.avg_pool2d(F.conv2d(x, w, b, 1, 1), 2)


def _inorm(x, weight=None, bias=None):
    tape.note("instats", x.shape[0], x.shape[2], x.shape[3], x.shape[1])
    return F.instance_norm(x, weight=weight, bias=bias, eps=1e-5)


def _resblk(x, sd, p, normalize, downsample):
    s = x
    if f"{p}.conv1x1.weight" in sd:
        s = _conv(s, sd, f"{p}.conv1x1")
    if downsample:
        s = F.avg_pool2d(s, 2)
    r = _inorm(x, sd[f"{p}.norm1.weight"], sd[f"{p}.norm1.bias"]) if normalize else x
    r = _lrelu(r)
    r = _conv3x3_pool(r, sd, f"{p}.conv1") if downsample else _conv3x3(r, sd, f"{p}.conv1")
    if normalize:
        r = _inorm(r, sd[f"{p}.norm2.weight"], sd[f"{p}.norm2.bias"])
    r = _conv3x3(_lrelu(r), sd, f"{p}.conv2")
    return (s + r) / math.sqrt(2)


def _adain(x, s, sd, p):
    h = F.linear(s, sd[f"{p}.fc.weight"], sd[f"{p}.fc.bias"])
    gamma, beta = h.chunk(2, dim=1)
    return (1 + gamma[:, :, None, None]) * _inorm(x) + beta[:, :, None, None]


def _adain_resblk(x, s, sd, p, upsample, w_hpf):
    r = _lrelu(_adain(x, s, sd, f"{p}.norm1"))
    r = _conv3x3_up(r, sd, f"{p}.conv1") if upsample else _conv3x3(r, sd, f"{p}.conv1")
    r = _conv3x3(_lrelu(_adain(r, s, sd, f"{p}.norm2")), sd, f"{p}.conv2")
    if w_hpf == 0:
        sc = x
        if f"{p}.conv1x1.weight" in sd:
            sc = _conv(sc, sd, f"{p}.conv1x1")
        if upsample:
            sc = F.interpolate(sc, scale_factor=2, mode="nearest")
        r = (r + sc) / math.sqrt(2)
    return r


def _highpass(x, w_hpf):
    k = torch.tensor([[-1.0, -1, -1], [-1, 8, -1], [-1, -1, -1]], dtype=x.dtype, device=x.device) / w_hpf
    return F.conv2d(x, k.expand(x.shape[1], 1, 3, 3), padding=1, groups=x.shape[1])


def _repeat_num(model: dict) -> int:
    return int(math.log2(model["img_size"])) - 4 + (1 if model["w_hpf"] > 0 else 0)


def encode(sd, model, x, masks):
    """The style-independent half: bottleneck and the masked high-pass
    skips ({size: hp}); ``x`` NCHW, ``masks`` two (B, 1, H, W)."""
    rn = _repeat_num(model)
    x = _conv(x, sd, "from_rgb", padding=1)
    cache = {}
    for i in range(rn + 2):
        if x.shape[-1] in (32, 64, 128):
            tape.note("instats", x.shape[0], x.shape[2], x.shape[3], x.shape[1])
            cache[x.shape[-1]] = x - x.mean()  # the mean over the whole batch
        x = _resblk(x, sd, f"encode.{i}", normalize=True, downsample=i < rn)
    hps = {}
    for size, feat in cache.items():
        mask = masks[0] if size == 32 else masks[1]
        mask = F.interpolate(mask, size=(size, size), mode="bilinear", align_corners=False)
        hps[size] = _highpass(mask * feat, model["w_hpf"])
    return x, hps


def decode(sd, model, z, s, hps):
    rn = _repeat_num(model)
    x = z
    for i in range(rn + 2):
        up = i >= 2
        x = _adain_resblk(x, s, sd, f"decode.{i}", up, model["w_hpf"])
        if up and x.shape[-1] in hps:
            x = x + hps[x.shape[-1]]
    x = _lrelu(_inorm(x, sd["to_rgb.0.weight"], sd["to_rgb.0.bias"]))
    return _conv(x, sd, "to_rgb.2")


def style_codes(sd, model, x, y):
    """StyleEncoder: NCHW images, integer domains -> (B, style_dim)."""
    repeat = int(math.log2(model["img_size"])) - 2
    h = _conv(x, sd, "shared.0", padding=1)
    for i in range(repeat):
        h = _resblk(h, sd, f"shared.{i + 1}", normalize=False, downsample=True)
    h = _lrelu(_conv(_lrelu(h), sd, f"shared.{repeat + 2}"))
    h = h.reshape(h.shape[0], -1)
    out = torch.stack([F.linear(h, sd[f"unshared.{d}.weight"], sd[f"unshared.{d}.bias"])
                       for d in range(model["num_domains"])], dim=1)
    return out[torch.arange(out.shape[0], device=out.device), y]


# --- FAN ------------------------------------------------------------------


def _bn(x, sd, p, eps=1e-5):
    """BatchNorm from its running statistics."""
    return F.batch_norm(x, sd[f"{p}.running_mean"], sd[f"{p}.running_var"], sd[f"{p}.weight"],
                        sd[f"{p}.bias"], False, 0.0, eps)


def _coords(h, w, like):
    x = (torch.arange(h, dtype=torch.float32) / (h - 1)) * 2 - 1
    y = (torch.arange(w, dtype=torch.float32) / (w - 1)) * 2 - 1
    xx, yy = x[:, None].expand(h, w), y[None, :].expand(h, w)
    rr = torch.sqrt(xx**2 + yy**2)
    c = torch.stack([xx, yy, rr / rr.max()])[None]
    return c.to(like.device, like.dtype).expand(like.shape[0], -1, -1, -1)


def _coordconv(x, sd, p, stride=1):
    w = sd[f"{p}.weight"]
    return F.conv2d(torch.cat([x, _coords(x.shape[2], x.shape[3], x)], 1), w, sd[f"{p}.bias"], stride,
                    w.shape[-1] // 2)


def _dense_block(x, sd, p):
    if x.shape[1] in (128, 256) and x.shape[1] == 2 * sd[f"{p}.conv1.weight"].shape[0]:
        tape.note("denseblock", x.shape[0], x.shape[2], x.shape[3], x.shape[1])
    o1 = F.conv2d(F.relu(_bn(x, sd, f"{p}.bn1")), sd[f"{p}.conv1.weight"], padding=1)
    o2 = F.conv2d(F.relu(_bn(o1, sd, f"{p}.bn2")), sd[f"{p}.conv2.weight"], padding=1)
    o3 = F.conv2d(F.relu(_bn(o2, sd, f"{p}.bn3")), sd[f"{p}.conv3.weight"], padding=1)
    res = x
    if f"{p}.downsample.2.weight" in sd:
        res = F.conv2d(F.relu(_bn(x, sd, f"{p}.downsample.0")), sd[f"{p}.downsample.2.weight"])
    return torch.cat([o1, o2, o3], 1) + res


def _hourglass(x, sd, d):
    up1 = _dense_block(x, sd, f"m0.b1_{d}")
    low = _dense_block(F.avg_pool2d(x, 2), sd, f"m0.b2_{d}")
    low = _hourglass(low, sd, d - 1) if d > 1 else _dense_block(low, sd, "m0.b2_plus_1")
    low = _dense_block(low, sd, f"m0.b3_{d}")
    return up1 + F.interpolate(low, scale_factor=2, mode="nearest")


def fan_heatmaps(sd, x, depth: int = 4):
    """FAN on NCHW images in [0, 1] -> (B, 99, H/4, W/4) head output."""
    x = F.relu(_bn(_coordconv(x, sd, "conv1.conv", stride=2), sd, "bn1"))
    x = F.avg_pool2d(_dense_block(x, sd, "conv2"), 2)
    x = _dense_block(_dense_block(x, sd, "conv3"), sd, "conv4")
    h = _hourglass(_coordconv(x, sd, "m0.coordconv.conv"), sd, depth)
    h = _dense_block(h, sd, "top_m_0")
    h = F.relu(_bn(_conv(h, sd, "conv_last0"), sd, "bn_end0"))
    return _conv(h, sd, "l0")


def privacy_masks(sd, x_nhwc, landmarks: int = 98):
    """The two privacy masks of an NHWC batch, (B, 1, 256, 256) each: the
    FAN at 256^2 on x*0.5+0.5, its landmark heatmaps upsampled (bilinear,
    corners aligned), summed over [0, L/2) and [L/2, L), clamped to [0, 1]."""
    x = x_nhwc.permute(0, 3, 1, 2)
    if x.shape[-1] != 256:
        x = F.interpolate(x, size=(256, 256), mode="bilinear", align_corners=False)
    hm = fan_heatmaps(sd, x * 0.5 + 0.5)[:, :landmarks]
    hm = F.interpolate(hm, size=(256, 256), mode="bilinear", align_corners=True)
    half = landmarks // 2
    m1 = hm[:, :half].sum(1, keepdim=True).clamp(0, 1)
    m2 = hm[:, half:].sum(1, keepdim=True).clamp(0, 1)
    return m1, m2


# --- the pipeline -----------------------------------------------------------


def privacy_front(states, cfg, x_src):
    """Sensor images (NHWC float32) and masks of a source batch."""
    cam = states["camera"]
    coeffs = torch.cat([cam["Zer_no_train"].reshape(-1), cam["Zer_train"].reshape(-1)])
    psf = optics.camera_psf(coeffs.double().cpu().numpy(), cfg["camera"], x_src.device)
    sensor = optics.camera_sensor(x_src, psf).float()
    return sensor, privacy_masks(states["fan"], sensor, cfg["fan"]["num_landmarks"])


def generate(states, cfg, sensor, masks, styles):
    """(R, B, H, W, 3) float32 outputs of the generator for each of R
    style rows (R, B, style_dim)."""
    g, model = states["generator"], cfg["model"]
    z, hps = encode(g, model, sensor.permute(0, 3, 1, 2), masks)
    return torch.stack([decode(g, model, z, s, hps).permute(0, 2, 3, 1) for s in styles])


def deid_batch(states, cfg, x_src, x_ref, y_ref):
    """Every (reference style, source) anonymization of one padded batch:
    (R, B, H, W, 3) float32 in the generator's range."""
    sensor, masks = privacy_front(states, cfg, x_src)
    s = style_codes(states["style_encoder"], cfg["model"], x_ref.permute(0, 3, 1, 2), y_ref)
    return generate(states, cfg, sensor, masks, s[:, None].expand(-1, x_src.shape[0], -1))


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """Saved-image space: clip(x * 255, 0, 255), truncated."""
    return torch.clamp(x * 255.0, 0, 255).to(torch.uint8)


def counted_batch(states, cfg, b: int, r: int):
    """``deid_batch`` on ``meta`` tensors of a batch of ``b`` sources and
    ``r`` styles, for the work counters (the camera's FFTs are not
    counted)."""
    n = cfg["model"]["img_size"]
    meta = {k: {n_: torch.empty(t.shape, device="meta") for n_, t in sd.items()} for k, sd in states.items()}
    sensor = torch.empty((b, n, n, 3), device="meta")
    masks = privacy_masks(meta["fan"], sensor, cfg["fan"]["num_landmarks"])
    s = style_codes(meta["style_encoder"], cfg["model"], torch.empty((r, 3, n, n), device="meta"),
                    torch.zeros(r, dtype=torch.long, device="meta"))
    return generate(meta, cfg, sensor, masks, s[:, None].expand(-1, b, -1))

