"""Face alignment: FAN landmarks -> similarity transform -> warp.

Port of ``ppvision_tpu/models/align.py`` (the reference aligner,
``Face-DeId/core/wing.py:14-33, 328-467``): sub-pixel landmarks from the
heatmaps (``get_preds_fromhm``), the eyes-and-mouth similarity against
the CelebA mean landmarks (numpy, f64, on the host), the mirror-pad with
a blurred fade-out, and the LANCZOS4 perspective warp.

The JAX package does the pad, blur and warp in OpenCV on the host; here
they are torch on the device, batched, written to give OpenCV's values:

- ``cv2.resize`` INTER_LINEAR is half-pixel bilinear (an exact 2x
  shrink averages 2x2), ``cv2.GaussianBlur(img, (0, 0), sigma)`` of a
  float image has ``round(8 sigma + 1) | 1`` taps of OpenCV's f32 kernel
  and ``BORDER_REFLECT_101`` (``F.pad`` "reflect");
- ``cv2.warpPerspective(..., INTER_LANCZOS4)`` rounds each source
  coordinate to 1/32 px (``INTER_BITS = 5``, ties to even), takes the
  8x8 taps at ``floor - 3 .. floor + 4`` with the f32 products of
  OpenCV's 1-D Lanczos table, and reads zeros outside the image
  (``BORDER_CONSTANT``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.image import resize_bilinear
from .fan import FAN, NUM_LANDMARKS

__all__ = ["FaceAligner", "gaussian_blur_cv2", "get_landmarks", "heatmap_landmarks", "pad_mirror", "warp_lanczos4"]


def heatmap_landmarks(hm: torch.Tensor) -> torch.Tensor:
    """Sub-pixel landmark coordinates from (B, H, W, C) heatmaps: the
    per-channel argmax (1-based grid), +-0.25 along the sign of the local
    gradient where the peak is interior, then -0.5 (wing.py:14-33).
    Returns (B, C, 2) as (x, y)."""
    b, h, w, c = hm.shape
    hm_c = hm.permute(0, 3, 1, 2)
    idx = torch.argmax(hm_c.reshape(b, c, h * w), dim=-1)
    px, py = idx % w, idx // w
    bidx = torch.arange(b, device=hm.device)[:, None]
    cidx = torch.arange(c, device=hm.device)[None, :]

    def at(yy, xx):
        return hm_c[bidx, cidx, yy.clamp(0, h - 1), xx.clamp(0, w - 1)]

    dx = at(py, px + 1) - at(py, px - 1)
    dy = at(py + 1, px) - at(py - 1, px)
    interior = (px > 0) & (px < w - 1) & (py > 0) & (py < h - 1)
    fx = px + 1 + torch.where(interior, 0.25 * torch.sign(dx).float(), 0.0)
    fy = py + 1 + torch.where(interior, 0.25 * torch.sign(dy).float(), 0.0)
    return torch.stack([fx - 0.5, fy - 0.5], dim=-1)


@torch.no_grad()
def get_landmarks(fan: FAN, x: torch.Tensor) -> torch.Tensor:
    """(B, 98, 2) landmarks in 256-frame pixels of an NHWC batch in
    [-1, 1] (wing.py:300-310): resize to 256, run the FAN, heatmap
    coordinates x4."""
    xr = resize_bilinear(x.permute(0, 3, 1, 2), (256, 256))
    out = fan(xr * 0.5 + 0.5).float()
    return heatmap_landmarks(out[:, :NUM_LANDMARKS].permute(0, 2, 3, 1)) * 4.0


# ---------------------------------------------------------------------------
# Similarity-transform estimation (numpy on the host; wing.py:353-425).
# ---------------------------------------------------------------------------

_EYE_L = np.array(list(range(60, 68)) + [96])
_EYE_R = np.array(list(range(68, 76)) + [97])


def _rotate90(v):
    return np.array([v[1], -v[0]])


def _xaxis(lm: np.ndarray) -> np.ndarray:
    eye_l = lm[_EYE_L].mean(axis=0)
    eye_r = lm[_EYE_R].mean(axis=0)
    mouth_l, mouth_r = lm[76], lm[82]
    xp = eye_r - eye_l
    yp = (eye_l + eye_r) / 2 - (mouth_l + mouth_r) / 2
    ax = xp - _rotate90(yp)
    return ax / np.linalg.norm(ax)


def _translation(points: np.ndarray, sign: float) -> np.ndarray:
    t = np.eye(3)
    t[:2, 2] = sign * points.mean(axis=0)
    return t


def _rotation(vec_src: np.ndarray, vec_ref: np.ndarray) -> np.ndarray:
    a = vec_src / np.linalg.norm(vec_src)
    bb = vec_ref / np.linalg.norm(vec_ref)
    c = float(a @ bb)
    cross = a[0] * bb[1] - a[1] * bb[0]
    s = np.sqrt(max(0.0, 1 - c * c)) * np.sign(cross)
    return np.array(((c, -s, 0), (s, c, 0), (0, 0, 1)))


def _scale(lm: np.ndarray, ref: np.ndarray) -> np.ndarray:
    xv = lm - lm.mean(axis=0)
    yv = ref - ref.mean(axis=0)
    idx = [96, 97, 76, 82]  # eyes and lip ends
    ratio = (np.linalg.norm(yv, axis=1) / np.linalg.norm(xv, axis=1))[idx].mean()
    s = np.eye(3)
    s[0, 0] = s[1, 1] = ratio
    return s


# ---------------------------------------------------------------------------
# OpenCV's blur and LANCZOS4 warp as torch ops (NHWC in, NHWC out).
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _cv2_gaussian_kernel(sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(round(8 sigma + 1) | 1, sigma, CV_32F)``:
    f32 taps, their f64 sum inverted and applied in f32."""
    n = int(np.rint(sigma * 8 + 1)) | 1
    x = np.arange(n) - (n - 1) * 0.5
    t = np.exp(-0.5 / (sigma * sigma) * x * x).astype(np.float32)
    return (t.astype(np.float64) * (1.0 / t.astype(np.float64).sum())).astype(np.float32)


def gaussian_blur_cv2(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """``cv2.GaussianBlur(x, (0, 0), sigma)`` of an NHWC float batch: the
    row pass, then the column pass, reflect-101 borders."""
    k = _cv2_gaussian_kernel(float(sigma))
    c, p = x.shape[-1], len(k) // 2
    w = torch.from_numpy(k).to(device=x.device, dtype=x.dtype)
    y = F.pad(x.permute(0, 3, 1, 2), (p, p, p, p), mode="reflect")
    y = F.conv2d(y, w.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)
    y = F.conv2d(y, w.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    return y.permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=4)
def _fade_weight(hh: int, ww: int) -> np.ndarray:
    """The mirror-pad's (hh, ww) fade weights (wing.py:438-442), f64."""
    yy, xx = np.meshgrid(np.arange(hh), np.arange(ww), indexing="ij")
    wy = np.clip(yy / (hh // 4), 0, 1)
    wx = np.clip(xx / (hh // 4), 0, 1)
    wy = np.minimum(wy, np.flip(wy, axis=0))
    wx = np.minimum(wx, np.flip(wx, axis=1))
    return np.minimum(wy, wx) ** 4


def pad_mirror(img: torch.Tensor) -> torch.Tensor:
    """Reflect-pad an NHWC (B, H, W, C) batch by half its size, and fade
    into a blurred copy towards the borders to hide the seams
    (wing.py:428-443): shrink to (H, W), blur with sigma ``H // 100``,
    grow back, blend with ``weight ** 4``.  H and W even."""
    b, h, w, c = img.shape
    padded = F.pad(img.permute(0, 3, 1, 2), (w // 2, w // 2, h // 2, h // 2), mode="reflect")
    hh, ww = padded.shape[-2:]
    small = resize_bilinear(padded, (h, w)).permute(0, 2, 3, 1)
    sigma = h // 100
    if sigma > 0:
        small = gaussian_blur_cv2(small, sigma)
    blurred = resize_bilinear(small.permute(0, 3, 1, 2), (2 * h, 2 * w))
    weight = torch.from_numpy(_fade_weight(hh, ww)).to(device=img.device, dtype=img.dtype)
    return (padded * weight + blurred * (1 - weight)).permute(0, 2, 3, 1)


INTER_BITS = 5
INTER_TAB_SIZE = 1 << INTER_BITS


def _lanczos4_coeffs(x: np.float32) -> np.ndarray:
    """OpenCV's ``interpolateLanczos4``: 8 f32 taps at offsets -3..4 of a
    fraction ``x``, normalized by their f32 sum."""
    if x < np.finfo(np.float32).eps:
        out = np.zeros(8, np.float32)
        out[3] = 1
        return out
    s45 = 0.70710678118654752440084436210485
    cs = ((1, 0), (-s45, -s45), (0, 1), (s45, -s45), (-1, 0), (s45, s45), (0, -1), (-s45, s45))
    y0 = -(float(x) + 3) * np.pi * 0.25
    s0, c0 = np.sin(y0), np.cos(y0)
    coeffs = np.zeros(8, np.float32)
    total = np.float32(0)
    for i in range(8):
        y = -(float(x) + 3 - i) * np.pi * 0.25
        coeffs[i] = np.float32((cs[i][0] * s0 + cs[i][1] * c0) / (y * y))
        total = np.float32(total + coeffs[i])
    return coeffs * (np.float32(1) / total)


@functools.lru_cache(maxsize=1)
def lanczos4_table() -> np.ndarray:
    """(32, 8) f32: the taps at each 1/32-px fraction (``initInterTab1D``)."""
    return np.stack([_lanczos4_coeffs(np.float32(i) * np.float32(1.0 / INTER_TAB_SIZE)) for i in range(INTER_TAB_SIZE)])


def warp_lanczos4(src: torch.Tensor, mats: np.ndarray, out_hw: tuple[int, int]) -> torch.Tensor:
    """``cv2.warpPerspective(src[b], mats[b], flags=INTER_LANCZOS4)`` for
    every image of an NHWC float batch, the top-left ``out_hw`` of each
    output.  ``mats``: (B, 3, 3) f64 source-to-destination maps; their
    inverses map each output pixel back, in f64, to a source coordinate
    rounded to 1/32 px."""
    b, h, w, c = src.shape
    oh, ow = out_hw
    dev = src.device
    inv = torch.from_numpy(np.linalg.inv(np.asarray(mats, np.float64))).to(dev)
    ys, xs = torch.meshgrid(
        torch.arange(oh, dtype=torch.float64, device=dev), torch.arange(ow, dtype=torch.float64, device=dev),
        indexing="ij",
    )

    def row(i):
        m = inv[:, i, :, None, None]
        return m[:, 0] * xs + m[:, 1] * ys + m[:, 2]

    wgt = row(2)
    wgt = torch.where(wgt != 0, INTER_TAB_SIZE / wgt, torch.zeros_like(wgt))
    lim = float(2**31 - 1)
    fx = torch.round((row(0) * wgt).clamp(-lim - 1, lim)).long()
    fy = torch.round((row(1) * wgt).clamp(-lim - 1, lim)).long()
    tab = torch.from_numpy(lanczos4_table()).to(dev)
    wx, wy = tab[fx & (INTER_TAB_SIZE - 1)], tab[fy & (INTER_TAB_SIZE - 1)]
    taps = (wy[..., :, None] * wx[..., None, :]).to(src.dtype)  # (B, oh, ow, 8, 8)
    k = torch.arange(-3, 5, device=dev)
    xx = (fx >> INTER_BITS)[..., None] + k  # (B, oh, ow, 8)
    yy = (fy >> INTER_BITS)[..., None] + k
    inside = ((yy >= 0) & (yy < h))[..., :, None] & ((xx >= 0) & (xx < w))[..., None, :]
    flat = yy.clamp(0, h - 1)[..., :, None] * w + xx.clamp(0, w - 1)[..., None, :]
    flat = flat + (torch.arange(b, device=dev) * (h * w)).view(b, 1, 1, 1, 1)
    vals = src.reshape(b * h * w, c)[flat]  # (B, oh, ow, 8, 8, C)
    return torch.einsum("bhwrk,bhwrkc->bhwc", taps * inside, vals)


class FaceAligner:
    """Align faces to the CelebA mean landmark frame, on the FAN's device."""

    def __init__(self, fan: FAN, celeba_mean_landmarks: np.ndarray, output_size: int = 256):
        self.fan = fan
        self.device = next(fan.parameters()).device
        scale = output_size // 256
        self.ref = np.float32(celeba_mean_landmarks) * scale
        self.ref_xaxis = _xaxis(self.ref)
        self.output_size = output_size

    def matrix(self, lm: np.ndarray) -> np.ndarray:
        """(3, 3) f64 map of one image's landmarks onto the mean frame."""
        t0 = _translation(lm, -1.0)
        r = _rotation(_xaxis(lm), self.ref_xaxis)
        s = _scale(lm, self.ref)
        t1 = _translation(self.ref, 1.0)
        return t1 @ s @ r @ t0

    @torch.no_grad()
    def align(self, imgs) -> np.ndarray:
        """(B, H, W, 3) images in [-1, 1] -> aligned, same range, f32 numpy."""
        x = torch.as_tensor(np.asarray(imgs, np.float32), device=self.device)
        lms = get_landmarks(self.fan, x).cpu().numpy()
        padded = pad_mirror((x * 0.5 + 0.5) * 255.0)
        hh, ww = padded.shape[1:3]
        # The landmarks move by the pad offset (h // 2, w // 2), which the
        # reference writes as the padded size // 4 (wing.py:444).
        mats = np.stack([self.matrix(lm + np.array([ww // 4, hh // 4])) for lm in lms])
        size = self.output_size
        warped = warp_lanczos4(padded, mats, (size, size))
        return (warped / 255.0 * 2.0 - 1.0).cpu().numpy()
