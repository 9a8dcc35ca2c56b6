"""Training debug visualization: the reference's 10-panel grid.

Port of ``ppvision_tpu/utils/debug.py``: the ``debug_every`` grid of
``Face-DeId/core/solver.py:216-248`` (top row Org / Priv / Fake / Rec /
Ref images, bottom row their FAN heatmaps in the jet colormap), written
to ``debug_dir/Img_{step}.svg`` with matplotlib, and a PSF image
(``Image_Caption/Camera/Utils.py:25-63``) written with PIL.  Both
libraries are imported inside the functions that draw.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from ..models.fan import get_heatmap
from ..optics.camera import camera_apply

__all__ = ["make_debug_forward", "save_debug_grid", "save_psf_image"]


def make_debug_forward(cfg, lat_style: bool = True):
    """``fwd(nets, frozen, batch) -> (images, heats)``: the debug tensors
    of a train batch under the current nets (dicts of NHWC numpy arrays;
    ``save_debug_grid`` draws the first sample).  Styles come from the
    mapping network, or with ``lat_style=False`` from the references."""
    fis = cfg.model.fan_input_size

    def first(h):
        return h[0] if isinstance(h, (tuple, list)) else h[..., :1]

    def nchw(x):
        return x.permute(0, 3, 1, 2)

    def nhwc(x):
        return x.permute(0, 2, 3, 1)

    @torch.no_grad()
    def fwd(nets: dict, frozen, batch: dict):
        gen, senc = nets["generator"], nets["style_encoder"]
        dev = next(gen.parameters()).device
        b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        x_src, x_ref = b["x_src"], b["x_ref"]
        y_src, y_trg = b["y_src"].long(), b["y_ref"].long()
        x_real, _ = camera_apply(frozen.camera, frozen.camera_consts, x_src)
        masks = get_heatmap(frozen.fan_priv, x_real, privacy=True, input_size=fis)
        if lat_style:
            s = nets["mapping_network"](b["z_trg"], y_trg)
        else:
            s = senc(nchw(x_ref), y_trg)
        x_fake = nhwc(gen(nchw(x_real), s, tuple(nchw(m) for m in masks)))
        x_rec = nhwc(gen(nchw(x_fake), senc(nchw(x_real), y_src), None))
        images = dict(Org=x_src, Priv=x_real, Fake=x_fake, Rec=x_rec, Ref=x_ref)
        heats = dict(
            Org=first(get_heatmap(frozen.fan, x_src, input_size=fis)),
            Priv=masks[0],
            Fake=first(get_heatmap(frozen.fan, x_fake, input_size=fis)),
            Rec=get_heatmap(frozen.fan_priv, x_rec, privacy=True, input_size=fis)[0],
            Ref=first(get_heatmap(frozen.fan, x_ref, input_size=fis)),
        )

        def host(d):
            return {k: v.float().cpu().numpy() for k, v in d.items()}

        return host(images), host(heats)

    return fwd


def save_debug_grid(images: dict, heats: dict, path: str) -> None:
    """2x5 matplotlib grid of the first sample (solver.py:223-247)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 5, figsize=(15, 6))
    for j, (name, img) in enumerate(images.items()):
        arr = np.asarray(img[0], np.float32)
        axes[0, j].imshow(np.clip(arr / max(arr.max(), 1e-8), 0, 1))
        axes[0, j].set_title(name)
        axes[0, j].axis("off")
    for j, (name, hm) in enumerate(heats.items()):
        axes[1, j].imshow(np.asarray(hm[0, ..., 0], np.float32), cmap="jet")
        axes[1, j].axis("off")
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)


def save_psf_image(psf: Any, path: str, log_scale: bool = True) -> None:
    """PSF (H, W, C) -> normalized PNG (Camera/Utils.py:25-63 analog)."""
    from PIL import Image

    arr = np.asarray(psf, np.float64)
    if log_scale:
        arr = np.log1p(arr / max(arr.max(), 1e-12) * 1e4)
    arr = arr / max(arr.max(), 1e-12)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray((arr * 255).astype(np.uint8)).save(path)
