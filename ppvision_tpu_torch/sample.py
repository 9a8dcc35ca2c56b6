"""Sampling and video utilities of the de-id pipeline.

Port of ``ppvision_tpu/sample.py`` (the reference's ``core/utils.py``
sampling helpers): ``translate_using_reference`` and
``translate_using_latent`` with psi truncation toward a mean style,
image grids, and the style-interpolation videos ``video_ref`` /
``video_latent``, whose frames for every alpha ride the generator's
batch axis in one call.  Inputs are NHWC tensors in [0, 1];
the work runs without autograd on the bundle's device, and frames come
back as numpy arrays.  ``write_video`` pipes frames to the ``ffmpeg``
binary and returns False where there is none.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np
import torch

from .deid import DeIdBundle, _nchw, _nhwc, _privacy_front, deid_from_reference

__all__ = [
    "dice_coefficient_batch",
    "get_alphas",
    "mean_style",
    "save_image_grid",
    "translate_using_latent",
    "translate_using_reference",
    "video_latent",
    "video_ref",
    "write_video",
]


def _to_uint8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(x) * 255.0, 0, 255).astype(np.uint8)


def save_image_grid(images: np.ndarray, path: str, ncol: int | None = None) -> None:
    """Tile (N, H, W, 3) [0, 1] images into one PNG (needs PIL)."""
    from PIL import Image

    n, h, w, _ = images.shape
    ncol = ncol or n
    nrow = -(-n // ncol)
    grid = np.zeros((nrow * h, ncol * w, 3), np.uint8)
    for i, img in enumerate(_to_uint8(images)):
        r, c = divmod(i, ncol)
        grid[r * h : (r + 1) * h, c * w : (c + 1) * w] = img
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(grid).save(path)


@torch.no_grad()
def translate_using_reference(
    bundle: DeIdBundle, x_src, x_ref, y_ref, out_dir: str | None = None, tag: int = 0
) -> np.ndarray:
    """One anonymized output per (reference, source) pair, (R, B, H, W, 3);
    with ``out_dir``, per-image PNGs and a [source row | fakes] summary
    (reference utils.py:151-196)."""
    b = x_src.shape[0]
    fakes = []
    for r in range(x_ref.shape[0]):
        ref = x_ref[r : r + 1].expand(x_src.shape)
        y = torch.full((b,), int(y_ref[r]), dtype=torch.long)
        fakes.append(deid_from_reference(bundle, x_src, ref, y).cpu().numpy())
    fakes_arr = np.stack(fakes)
    if out_dir:
        from PIL import Image

        os.makedirs(out_dir, exist_ok=True)
        for r in range(fakes_arr.shape[0]):
            for i in range(b):
                Image.fromarray(_to_uint8(fakes_arr[r, i])).save(os.path.join(out_dir, f"ref{tag}_{r}_{i}.png"))
        rows = np.concatenate([x_src.cpu().numpy()[None], fakes_arr], axis=0)
        save_image_grid(rows.reshape(-1, *rows.shape[2:]), os.path.join(out_dir, f"reference_{tag}.png"), ncol=b)
    return fakes_arr


@torch.no_grad()
def mean_style(bundle: DeIdBundle, y: int, num: int = 10_000, seed: int = 0, z=None) -> torch.Tensor:
    """Mean mapped style of domain ``y`` over ``num`` latents (the
    psi-truncation anchor, reference utils.py:121-127), (1, style_dim).
    The latents come from ``torch.Generator().manual_seed(seed)`` unless
    given as ``z`` (num, latent_dim)."""
    if z is None:
        g = torch.Generator().manual_seed(seed)
        z = torch.randn((num, bundle.cfg.model.latent_dim), generator=g)
    z = z.to(bundle.device)
    ys = torch.full((z.shape[0],), y, dtype=torch.long, device=bundle.device)
    return torch.mean(bundle.mapping_network(z, ys), dim=0, keepdim=True)


@torch.no_grad()
def translate_using_latent(
    bundle: DeIdBundle, x_src, y_trg: int, z_list, psi: float = 1.0, out_path: str | None = None
) -> np.ndarray:
    """Latent-style outputs (len(z_list), B, H, W, 3) with psi truncation
    toward the mean style."""
    s_avg = mean_style(bundle, y_trg)
    x_priv, masks = _privacy_front(bundle, x_src)
    y = torch.full((x_src.shape[0],), y_trg, dtype=torch.long, device=bundle.device)
    outs = []
    for z in z_list:
        s = bundle.mapping_network(z.to(bundle.device), y)
        s = s_avg + psi * (s - s_avg)
        outs.append(_nhwc(bundle.generator(_nchw(x_priv), s, masks)).cpu().numpy())
    result = np.stack(outs)
    if out_path:
        save_image_grid(result.reshape(-1, *result.shape[2:]), out_path, x_src.shape[0])
    return result


def write_video(frames: np.ndarray, path: str, fps: int = 24) -> bool:
    """(T, H, W, 3) [0, 1] frames -> mp4 through the ffmpeg binary (the
    reference pipes through ffmpeg too); False if there is none."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cmd = [
        "ffmpeg", "-y", "-f", "rawvideo", "-pix_fmt", "rgb24",
        "-s", f"{frames.shape[2]}x{frames.shape[1]}", "-r", str(fps),
        "-i", "-", "-pix_fmt", "yuv420p", path,
    ]
    try:
        proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    except FileNotFoundError:
        return False
    proc.communicate(_to_uint8(frames).tobytes())
    return proc.returncode == 0


def get_alphas(start=-5.0, end=5.0, step=0.5, len_tail=10) -> np.ndarray:
    """Sigmoid-eased interpolation schedule (reference utils.py:263-264)."""
    mid = 1.0 / (1.0 + np.exp(-np.arange(start, end, step)))
    return np.concatenate([[0.0], mid, np.ones(len_tail)]).astype(np.float32)


def _interpolate_frames(bundle: DeIdBundle, x_priv, masks, s_prev, s_next, alphas) -> torch.Tensor:
    """All interpolation frames (T, B, H, W, 3) in one generator call: the
    styles of every alpha ride the batch axis (T*B), the encoder runs once
    at B.  Each frame is min-max normalized (utils.py:278)."""
    b, h, w, _ = x_priv.shape
    t = len(alphas)
    a = torch.as_tensor(alphas, device=s_prev.device)[:, None, None]
    styles = s_prev[None] + a * (s_next[None] - s_prev[None])  # (T, 1, D)
    styles = styles.expand(t, b, styles.shape[-1]).reshape(t * b, -1)
    fakes = _nhwc(bundle.generator(_nchw(x_priv), styles, masks)).reshape(t, b, h, w, -1)
    lo = torch.amin(fakes, dim=(1, 2, 3, 4), keepdim=True)
    hi = torch.amax(fakes, dim=(1, 2, 3, 4), keepdim=True)
    return (fakes - lo) / (hi - lo + 1e-8)


def _slide_canvas(x_prev: np.ndarray, x_next: np.ndarray, alphas, margin=32) -> np.ndarray:
    """Sliding reference window (reference utils.py:287-308): the next
    reference slides up over the previous one; (T, 2H, W + margin, 3)."""
    h, w, _ = x_prev.shape[1:]
    merged = np.concatenate([x_prev[0], x_next[0]], axis=0)
    canvas = np.zeros((len(alphas), 2 * h, w + margin, 3), np.float32)
    for ti, alpha in enumerate(alphas):
        top = int(h * (1.0 - alpha))
        canvas[ti, top : 2 * h, :w] = merged[: 2 * h - top]
    return canvas


def _grid_rows(x_src: np.ndarray, fakes: np.ndarray) -> np.ndarray:
    """(T, B, H, W, 3) fakes + (B, H, W, 3) sources -> (T, 2H, B*W, 3):
    the source row above the fake row."""
    t, b, h, w, c = fakes.shape
    out = np.empty((t, 2 * h, b * w, c), np.float32)
    out[:, :h] = np.concatenate(list(x_src), axis=1)[None]
    out[:, h:] = fakes.transpose(0, 2, 1, 3, 4).reshape(t, h, b * w, c)
    return out


def _finish_video(segments: list, fname: str, fps: int, what: str) -> np.ndarray:
    if not segments:
        raise ValueError(f"need >= 2 {what}")
    segments.append(np.repeat(segments[-1][-1:], 10, axis=0))
    video = np.concatenate(segments)
    write_video(video, fname, fps=fps)
    return video


@torch.no_grad()
def video_ref(bundle: DeIdBundle, x_src, x_ref, y_ref, fname: str, fps: int = 15) -> np.ndarray:
    """Reference-interpolation de-id video (reference utils.py:310-341):
    the camera privatizes ``x_src`` once; for every consecutive
    same-domain pair of reference faces the styles are interpolated and
    the frames rendered beside a slide panel of the two references.
    Returns the (T, 2H, W + 32 + B*W, 3) frames; writes ``fname`` where
    ffmpeg exists."""
    x_priv, masks = _privacy_front(bundle, x_src)
    s_ref = bundle.style_encoder(_nchw(x_ref.to(bundle.device)), y_ref.to(bundle.device))
    src_np, ref_np = x_src.cpu().numpy(), x_ref.cpu().numpy()
    alphas = get_alphas()
    segments, prev = [], None
    for r in range(x_ref.shape[0]):
        cur = (ref_np[r : r + 1], int(y_ref[r]), s_ref[r : r + 1])
        if prev is None or prev[1] != cur[1]:
            prev = cur
            continue
        fakes = _interpolate_frames(bundle, x_priv, masks, prev[2], cur[2], alphas).cpu().numpy()
        slided = _slide_canvas(prev[0], cur[0], alphas)
        segments.append(np.concatenate([slided, _grid_rows(src_np, fakes)], axis=2))
        prev = cur
    return _finish_video(segments, fname, fps, "reference images of the same domain")


@torch.no_grad()
def video_latent(bundle: DeIdBundle, x_src, y_list, z_list, psi: float, fname: str, fps: int = 15) -> np.ndarray:
    """Latent-interpolation video with psi truncation (utils.py:344-374)."""
    s_list = []
    for y in y_list:
        s_avg = mean_style(bundle, y)
        for z in z_list:
            z = z.to(bundle.device)
            ys = torch.full((z.shape[0],), y, dtype=torch.long, device=bundle.device)
            s = bundle.mapping_network(z, ys)
            s_list.append(s_avg + psi * (s - s_avg))
    x_priv, masks = _privacy_front(bundle, x_src)
    src_np = x_src.cpu().numpy()
    alphas = get_alphas()
    segments, s_prev = [], None
    for idx, s_next in enumerate(s_list):
        if s_prev is None or idx % len(z_list) == 0:
            s_prev = s_next
            continue
        fakes = _interpolate_frames(bundle, x_priv, masks, s_prev, s_next, alphas).cpu().numpy()
        segments.append(_grid_rows(src_np, fakes))
        s_prev = s_next
    return _finish_video(segments, fname, fps, "latent codes per domain")


def dice_coefficient_batch(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Per-sample Dice overlap of binary masks (reference utils.py:428-434)."""
    dims = tuple(range(1, a.ndim))
    inter = torch.sum(a * b, dim=dims)
    return (2.0 * inter + eps) / (torch.sum(a, dim=dims) + torch.sum(b, dim=dims) + eps)
