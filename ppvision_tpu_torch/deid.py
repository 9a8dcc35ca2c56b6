"""Flagship de-identification pipeline: camera -> heatmaps -> generator.

Port of ``ppvision_tpu/deid.py`` (the reference's ``--mode sample``,
``Face-DeId/core/utils.py:152-196``):

1. the learned-optics camera forms the privacy-preserved image;
2. the FAN regresses the two privacy heatmap masks from it;
3. the StarGAN-v2 generator synthesizes the anonymized face from the
   privacy image, the masks and a style code (from a reference face or
   a latent z).

Entry points take and return NHWC tensors like the JAX package's, run
without autograd, and run on the bundle's device (CUDA unless
``build_deid(device="cpu")``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .config import FaceDeIdConfig
from .models.fan import FAN, get_heatmap
from .models.stargan import build_gan_models, init_params_
from .optics.camera import Camera, CameraConstants, CameraSpec, camera_apply, make_camera_constants
from .utils.device import resolve_device
from .utils.validate import check_image_batch, check_labels

__all__ = [
    "DeIdBundle",
    "build_deid",
    "deid_from_latent",
    "deid_from_reference",
    "deid_from_styles",
    "deid_multi_style",
]


@dataclasses.dataclass
class DeIdBundle:
    """Config, modules and camera constants of the pipeline, on one device."""

    cfg: FaceDeIdConfig
    device: torch.device
    camera: Camera
    camera_consts: CameraConstants
    fan: FAN
    generator: nn.Module
    mapping_network: nn.Module
    style_encoder: nn.Module

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.model.compute_dtype)


def build_deid(seed: int = 0, cfg: FaceDeIdConfig | None = None, device="cuda") -> DeIdBundle:
    """The pipeline with fresh seeded weights (he-init for the GAN nets,
    LeCun-normal for the FAN, U[0, 1)/100 Zernike coefficients).  Load
    trained or carried-over weights with each module's
    ``load_state_dict``."""
    cfg = cfg or FaceDeIdConfig()
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.model.compute_dtype)
    m = cfg.model
    models = build_gan_models(
        img_size=m.img_size,
        style_dim=m.style_dim,
        latent_dim=m.latent_dim,
        num_domains=m.num_domains,
        w_hpf=m.w_hpf,
        max_conv_dim=m.max_conv_dim,
        dtype=dtype,
        quant_decode=m.quant_decode,
    )
    spec = CameraSpec(n=m.img_size, zernike_terms=cfg.camera.zernike_terms)
    camera = Camera(spec, seed=seed)
    fan = init_params_(FAN(dtype=dtype), seed + 1, gain=1.0)
    for i, name in enumerate(("generator", "mapping_network", "style_encoder")):
        init_params_(models[name], seed + 2 + i)

    def ready(mod: nn.Module) -> nn.Module:
        return mod.to(dev).eval().requires_grad_(False)

    return DeIdBundle(
        cfg=cfg,
        device=dev,
        camera=ready(camera),
        camera_consts=make_camera_constants(spec, dev),
        fan=ready(fan),
        generator=ready(models["generator"]),
        mapping_network=ready(models["mapping_network"]),
        style_encoder=ready(models["style_encoder"]),
    )


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


def _privacy_front(bundle: DeIdBundle, x_src: torch.Tensor):
    """Sensor image (NHWC) and the two privacy masks (NCHW)."""
    check_image_batch(x_src, "x_src", size=bundle.cfg.model.img_size)
    x_priv, _ = camera_apply(bundle.camera, bundle.camera_consts, x_src.to(bundle.device))
    masks = get_heatmap(bundle.fan, x_priv, privacy=True)
    return x_priv, tuple(_nchw(m) for m in masks)


@torch.no_grad()
def deid_from_reference(bundle: DeIdBundle, x_src, x_ref, y_ref) -> torch.Tensor:
    """Anonymize ``x_src`` in the style of reference faces ``x_ref``:
    (B, H, W, 3) f32."""
    check_image_batch(x_ref, "x_ref", size=bundle.cfg.model.img_size)
    check_labels(y_ref, "y_ref", batch=x_ref.shape[0])
    x_priv, masks = _privacy_front(bundle, x_src)
    s_ref = bundle.style_encoder(_nchw(x_ref.to(bundle.device)), y_ref.to(bundle.device))
    return _nhwc(bundle.generator(_nchw(x_priv), s_ref, masks))


@torch.no_grad()
def deid_from_latent(bundle: DeIdBundle, x_src, z, y_trg) -> torch.Tensor:
    """Anonymize ``x_src`` with styles mapped from latent codes ``z``."""
    check_labels(y_trg, "y_trg", batch=x_src.shape[0])
    x_priv, masks = _privacy_front(bundle, x_src)
    s = bundle.mapping_network(z.to(bundle.device), y_trg.to(bundle.device))
    return _nhwc(bundle.generator(_nchw(x_priv), s, masks))


@torch.no_grad()
def deid_from_styles(bundle: DeIdBundle, x_src, styles: torch.Tensor) -> torch.Tensor:
    """Anonymizations of ``x_src`` (B, H, W, 3) under each row of style
    codes ``styles`` (R, B, style_dim): (R, B, H, W, 3) f32.

    The privacy front and the generator's encoder run once at batch B;
    the style-modulated decoder runs once per style into a preallocated
    buffer in the compute dtype, cast to f32 once at the end
    (deid.py:173-188 of the JAX package)."""
    x_priv, masks = _privacy_front(bundle, x_src)
    gen = bundle.generator
    z, hps = gen.encode(_nchw(x_priv), masks)
    b, h, w, _ = x_src.shape
    fakes = torch.empty((styles.shape[0], b, h, w, 3), dtype=bundle.compute_dtype, device=bundle.device)
    for i, sb in enumerate(styles):
        fakes[i] = _nhwc(gen.decode(z, sb, hps))
    return fakes.float()


@torch.no_grad()
def deid_multi_style(bundle: DeIdBundle, x_src, x_ref, y_ref) -> torch.Tensor:
    """All (reference style, source) anonymizations: (R, B, H, W, 3) f32,
    one style per reference face."""
    s_ref = bundle.style_encoder(_nchw(x_ref.to(bundle.device)), y_ref.to(bundle.device))
    return deid_from_styles(bundle, x_src, s_ref[:, None].expand(-1, x_src.shape[0], -1))
