"""Pretrained-weight wiring: checkpoints -> frozen nets and aux losses.

Port of ``ppvision_tpu/train/pretrained.py``.  The reference Solver
loads several pretrained artifacts at init (Face-DeId/core/solver.py:
44-48, 92-104; core/model.py:298):

- ``Model_wing.pth``: ``{'Camera': camera state, 'Decoder': fan_priv
  state}``;
- ``wing.ckpt``: the clean-image FAN;
- ``lpips_weights.ckpt`` and a torchvision AlexNet: LPIPS;
- ``raft-things.pth``: the flow loss's RAFT.

The port's modules keep the reference state_dict names, so each file
loads straight into its module.  Where a file is absent the module
keeps a fresh seeded init and a loud warning says so: smoke runs work
anywhere, and a run that silently trains another model than the
paper's cannot happen.

The CLI's warm start (:func:`warm_start_state`) and its restore for
``--mode sample`` (:func:`restore_deid_params`) also read the reference
GAN checkpoints ``{:06d}_nets(_ema).ckpt`` (``{net: state_dict}``) and
the port's own ``StepCheckpoints`` groups (``nets``, ``nets_ema``,
``optims``, ``camera``), in the JAX package's order of priority.
"""

from __future__ import annotations

import os
import sys
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..config import FaceDeIdConfig
from ..metrics.lpips import lpips_state_dict_from_reference
from ..models.fan import FAN
from ..models.stargan import init_params_
from ..optics.camera import Camera, CameraSpec, make_camera_constants
from ..utils.checkpoint import StepCheckpoints
from ..utils.device import resolve_device
from .aux_losses import build_flow_fn, build_lpips_fn
from .gan import EMA_NETS, GAN_NETS, FrozenNets

__all__ = [
    "build_aux_losses",
    "import_reference_gan_nets",
    "load_frozen_nets",
    "load_state_dict_file",
    "restore_deid_params",
    "warm_start_state",
    "warn_random_init",
]


def warn_random_init(what: str, path: str) -> None:
    print(
        f"WARNING: {what} checkpoint not found at {path!r} — using RANDOM "
        "init. Results will NOT match the paper.",
        file=sys.stderr,
    )


def _flat(obj) -> dict[str, torch.Tensor]:
    """A module or state_dict -> its tensors, DataParallel's ``module.``
    prefix dropped."""
    sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    return {k.replace("module.", ""): v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def load_state_dict_file(path: str) -> dict[str, torch.Tensor]:
    """``torch.load`` a checkpoint on the CPU -> its flat state_dict."""
    return _flat(torch.load(path, map_location="cpu", weights_only=False))


def _load(module: nn.Module, sd: dict[str, torch.Tensor], what: str) -> None:
    """Fill every port key of ``module`` from ``sd``; keys the port does
    not hold are ignored, as the reference loads non-strict."""
    missing, _ = module.load_state_dict(sd, strict=False)
    if missing:
        raise KeyError(f"{what}: the checkpoint lacks {missing[:8]} ({len(missing)} keys)")


def _load_camera_and_fan_priv(cfg: FaceDeIdConfig, camera: Camera, fan_priv: FAN) -> None:
    """Fill the camera and ``fan_priv`` from ``Model_wing.pth`` where it
    exists (``{'Camera': ..., 'Decoder': ...}``, solver.py:87-90)."""
    path = cfg.paths.camera_ckpt
    if path and os.path.exists(path):
        obj = torch.load(path, map_location="cpu", weights_only=False)
        if "Camera" in obj:
            _load(camera, _flat(obj["Camera"]), path)
        # The reference loads the decoder into nets_ema.fan_priv, which is
        # nets.fan_priv (model.py:304-308).
        for key in ("Decoder", "Mask"):
            if key in obj:
                _load(fan_priv, _flat(obj[key]), path)
                break
    else:
        warn_random_init("camera+fan_priv (Model_wing.pth)", path)


def load_frozen_nets(cfg: FaceDeIdConfig, seed: int = 0, device="cuda") -> FrozenNets:
    """The camera, the clean-image FAN and ``fan_priv``, pretrained where
    the files exist (reference solver.py:44-48, 99), frozen, on the card
    unless ``device="cpu"``."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.model.compute_dtype)
    spec = CameraSpec(n=cfg.model.img_size, zernike_terms=cfg.camera.zernike_terms)
    camera = Camera(spec, seed=seed)
    fan_priv = init_params_(FAN(dtype=dtype), seed + 1, gain=1.0)
    fan = init_params_(FAN(dtype=dtype), seed + 2, gain=1.0)
    _load_camera_and_fan_priv(cfg, camera, fan_priv)
    path = cfg.paths.wing_path
    if path and os.path.exists(path):
        _load(fan, load_state_dict_file(path), path)
    else:
        warn_random_init("FAN (wing.ckpt)", path)

    def ready(m: nn.Module) -> nn.Module:
        return m.to(dev).eval().requires_grad_(False)

    return FrozenNets(
        camera=ready(camera), camera_consts=make_camera_constants(spec, dev), fan=ready(fan), fan_priv=ready(fan_priv)
    )


def build_aux_losses(
    cfg: FaceDeIdConfig, seed: int = 0, device="cuda"
) -> tuple[Callable | None, Callable | None]:
    """The LPIPS and RAFT-flow losses the config asks for, with the
    reference weights where the files exist (solver.py:32-33)."""
    lpips_fn = flow_fn = None
    if cfg.train.use_lpips:
        sd = None
        lp, ap = cfg.paths.lpips_path, cfg.paths.alexnet_path
        if os.path.exists(lp) and os.path.exists(ap):
            sd = lpips_state_dict_from_reference(load_state_dict_file(ap), load_state_dict_file(lp))
        else:
            warn_random_init("LPIPS (alexnet + lpips_weights)", f"{ap} / {lp}")
        lpips_fn, _ = build_lpips_fn(sd, seed=seed + 3, device=device)
    if cfg.train.use_flow:
        sd = None
        if os.path.exists(cfg.paths.raft_path):
            sd = load_state_dict_file(cfg.paths.raft_path)
        else:
            warn_random_init("RAFT (raft-things.pth)", cfg.paths.raft_path)
        # The pyramid's depth must fit the 1/8-resolution feature map (4
        # levels at the reference's 256^2).
        fmap = max(cfg.model.img_size // 8, 1)
        corr_levels = max(1, min(4, int(np.log2(fmap)) + 1))
        flow_fn, _ = build_flow_fn(
            sd, seed=seed + 4, iters=cfg.train.flow_iters, corr_levels=corr_levels, device=device
        )
    return lpips_fn, flow_fn


def import_reference_gan_nets(path: str) -> dict[str, dict[str, torch.Tensor]]:
    """A reference ``{:06d}_nets(_ema).ckpt`` -> the state_dicts of
    whichever of G, the mapping network, the style encoder and D it holds
    (``module.`` prefixes dropped); the port keeps their key names."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    return {name: _flat(obj[name]) for name in GAN_NETS if name in obj}


def warm_start_state(state, cfg: FaceDeIdConfig):
    """Warm-start training as the reference does (solver.py:92-99): load
    from ``cfg.paths.checkpoint_dir`` (the latest ``nets`` group of a
    previous run, with its ``nets_ema`` where saved) or else from a
    reference ``{:06d}_nets.ckpt`` (``cfg.paths.torch_nets_ckpt``, with a
    sibling ``_nets_ema.ckpt`` for the EMA copies where there is one; an
    EMA net with no source copies its warm-started net); training then
    saves to ``checkpoint_save_dir``.  Optimizer states start fresh.
    Updates ``state`` in place; returns ``(state, True)`` when something
    loaded."""
    if os.path.isdir(cfg.paths.checkpoint_dir):
        src = StepCheckpoints(cfg.paths.checkpoint_dir)
        step = src.latest_step("nets")
        if step is not None:
            for name, sd in src.load(step, "nets").items():
                state.nets[name].load_state_dict(sd)
            if os.path.exists(src.path(step, "nets_ema")):
                for name, sd in src.load(step, "nets_ema").items():
                    state.ema[name].load_state_dict(sd)
            print(f"Warm start from {cfg.paths.checkpoint_dir} step {step}")
            return state, True
    tck = cfg.paths.torch_nets_ckpt
    if tck and os.path.exists(tck):
        nets = import_reference_gan_nets(tck)
        for name, sd in nets.items():
            _load(state.nets[name], sd, tck)
        ema = {k: nets.get(k, state.nets[k].state_dict()) for k in EMA_NETS}
        ema_path = tck.replace("_nets.ckpt", "_nets_ema.ckpt")
        if ema_path != tck and os.path.exists(ema_path):
            ema.update({k: v for k, v in import_reference_gan_nets(ema_path).items() if k in ema})
        for name, sd in ema.items():
            _load(state.ema[name], sd, ema_path)
        print(f"Warm start from reference checkpoint {tck}")
        return state, True
    return state, False


def restore_deid_params(bundle, cfg: FaceDeIdConfig, step: int | None = None):
    """Load the weights ``--mode sample`` runs into the bundle's modules,
    in place (the JAX package's priority): the camera and ``fan_priv``
    from ``Model_wing.pth`` where it exists (as at train time); then (1)
    G, the mapping network and the style encoder from a reference
    ``cfg.paths.torch_nets_ckpt`` (the ``_nets_ema.ckpt`` format); or (2)
    the latest (or ``step``) ``nets_ema`` group, and its ``camera`` group
    where saved, under ``cfg.paths.checkpoint_save_dir``; or (3) the
    bundle's seeded init, with a loud warning.  Returns the bundle."""
    _load_camera_and_fan_priv(cfg, bundle.camera, bundle.fan)
    tck = cfg.paths.torch_nets_ckpt
    if tck and os.path.exists(tck):
        nets = import_reference_gan_nets(tck)
        for name in EMA_NETS:
            _load(getattr(bundle, name), nets[name], tck)
        return bundle
    ckpts = StepCheckpoints(cfg.paths.checkpoint_save_dir)
    step = step if step is not None else ckpts.latest_step("nets_ema")
    if step is not None and os.path.exists(ckpts.path(step, "nets_ema")):
        for name, sd in ckpts.load(step, "nets_ema").items():
            getattr(bundle, name).load_state_dict(sd)
        if os.path.exists(ckpts.path(step, "camera")):
            bundle.camera.load_state_dict(ckpts.load(step, "camera"))
        print(f"Restored nets_ema from step {step} in {ckpts.root}")
    else:
        warn_random_init("GAN nets (nets_ema)", cfg.paths.checkpoint_save_dir)
    return bundle
