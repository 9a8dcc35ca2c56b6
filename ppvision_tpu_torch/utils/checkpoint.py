"""Checkpoint / resume of GAN training with ``torch.save``.

Port of ``ppvision_tpu/utils/checkpoint.py``'s ``StepCheckpoints``
(reference ``Face-DeId/core/checkpoint.py``): step-templated groups
under one directory, ``{step:06d}_{group}.ckpt``, each a dict of
state_dicts: ``nets`` and ``nets_ema`` in the reference's own format,
``optims`` the optimizers' states.  A file is written under a temporary
name and renamed, so a crash never leaves half a checkpoint.
"""

from __future__ import annotations

import os
import re
from typing import Any

import torch

__all__ = ["StepCheckpoints", "restore_train_state", "save_train_state"]


class StepCheckpoints:
    """Step-templated checkpoint groups under one root directory."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def path(self, step: int, group: str) -> str:
        return os.path.join(self.root, f"{step:06d}_{group}.ckpt")

    def save(self, step: int, group: str, obj: Any) -> str:
        path = self.path(step, group)
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(obj, tmp)
        os.replace(tmp, path)
        return path

    def load(self, step: int, group: str) -> Any:
        return torch.load(self.path(step, group), map_location="cpu", weights_only=True)

    def latest_step(self, group: str = "nets") -> int | None:
        pat = re.compile(rf"^(\d{{6}})_{re.escape(group)}\.ckpt$")
        steps = [int(m.group(1)) for f in os.listdir(self.root) if (m := pat.match(f))]
        return max(steps) if steps else None


def save_train_state(ckpts: StepCheckpoints, state) -> None:
    """The nets, the EMA nets and the optimizers of a
    ``train.gan.GANTrainState`` at its step."""
    ckpts.save(state.step, "nets", {k: m.state_dict() for k, m in state.nets.items()})
    ckpts.save(state.step, "nets_ema", {k: m.state_dict() for k, m in state.ema.items()})
    ckpts.save(state.step, "optims", {k: o.state_dict() for k, o in state.optims.items()})


def restore_train_state(ckpts: StepCheckpoints, state, step: int | None = None):
    """Load a saved step (the latest by default) into ``state`` in place:
    the nets, EMA nets and optimizers, and the step count."""
    step = ckpts.latest_step("nets") if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpts.root}")
    for group, parts in (("nets", state.nets), ("nets_ema", state.ema), ("optims", state.optims)):
        saved = ckpts.load(step, group)
        for name, part in parts.items():
            part.load_state_dict(saved[name])
    state.step = step
    return state
