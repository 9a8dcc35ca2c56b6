"""The GAN trainer's auxiliary losses.

Port of ``ppvision_tpu/train/aux_losses.py``.  The reference Solver
builds LPIPS and a RAFT flow loss at init (solver.py:32-33) and mixes
them into the generator steps (solver.py:161-184).  These functions give
the ``lpips_fn`` / ``flow_fn`` callables that
``train.gan.make_train_step`` takes, with the nets frozen: weights from
a state_dict where one is given, fresh seeded ones otherwise.
"""

from __future__ import annotations

from typing import Callable

from torch import nn

from ..metrics.lpips import LPIPS
from ..models.raft import build_raft, raft_flow_loss
from ..models.stargan import init_params_
from ..utils.device import resolve_device

__all__ = ["build_flow_fn", "build_lpips_fn"]


def build_lpips_fn(state_dict=None, seed: int = 0, device="cuda", dtype=None) -> tuple[Callable, nn.Module]:
    """The LPIPS distance of two NHWC batches and its frozen module
    (reference solver.py:32, 176).  Fresh AlexNet convs take LeCun-normal
    weights and zero biases, the learned weights ones, as the JAX
    package's init."""
    model = LPIPS(dtype=dtype)
    init_params_(model.alexnet, seed, gain=1.0)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model = model.to(resolve_device(device)).eval().requires_grad_(False)

    def lpips_fn(x, y):
        return model(x, y)

    return lpips_fn, model


def build_flow_fn(
    state_dict=None, seed: int = 0, iters: int = 20, corr_levels: int = 4, corr_radius: int = 4, device="cuda"
) -> tuple[Callable, nn.Module]:
    """The RAFT temporal-consistency loss of two NHWC frame batches in
    [0, 255] and its frozen RAFT (reference solver.py:33, ``loss_RAFT``
    with 20 iterations).  It runs the dense correlation pyramid, as the
    JAX package's loss does; the gradient reaches the frames."""
    raft = build_raft(seed, device, corr_levels=corr_levels, corr_radius=corr_radius)
    if state_dict is not None:
        raft.load_state_dict(state_dict)

    def flow_fn(frames1, frames2):
        return raft_flow_loss(raft, frames1, frames2, iters=iters)

    return flow_fn, raft
