"""Seeded weights, made by the benchmark and handed to both sides.

A configuration's ``init`` lists rules ``[regex, kind, *args]``; the
first rule whose pattern matches a tensor's ``module.name`` sets it:

- ``zeros``, ``ones``, ``const v``;
- ``uniform lo hi``;
- ``normal_fan_in gain``: N(0, gain / fan_in), fan_in = numel / shape[0];
- ``uniform_fan_in``: U(-1/sqrt(fan_in), 1/sqrt(fan_in)).

Every random tensor of a module set is cut from one draw on the device
(a ``torch.Generator`` seeded from ``--seed``), in name order, so the
same seed gives the same weights whatever the program's own init does.
"""

from __future__ import annotations

import math
import re

import torch

__all__ = ["make_states"]


def _rule(rules, name: str):
    for r in rules:
        if re.search(r[0], name):
            return r[1], r[2:]
    raise KeyError(f"no init rule matches {name!r}")


def make_states(shapes: dict[str, dict[str, tuple]], rules: list, seed: int, device) -> dict:
    """{module: {name: float32 tensor}} for the given {module: {name:
    shape}} (integer leaves such as ``num_batches_tracked`` are zeros)."""
    plan = []
    n_normal = n_uniform = 0
    for mod in sorted(shapes):
        for name in sorted(shapes[mod]):
            shape = tuple(shapes[mod][name])
            kind, args = _rule(rules, f"{mod}.{name}")
            numel = math.prod(shape)
            if kind == "normal_fan_in":
                plan.append((mod, name, shape, kind, args, n_normal))
                n_normal += numel
            elif kind in ("uniform", "uniform_fan_in"):
                plan.append((mod, name, shape, kind, args, n_uniform))
                n_uniform += numel
            else:
                plan.append((mod, name, shape, kind, args, None))
    g = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    normal = torch.randn(n_normal, generator=g, device=device)
    uniform = torch.rand(n_uniform, generator=g, device=device)
    states: dict = {m: {} for m in shapes}
    for mod, name, shape, kind, args, off in plan:
        numel = math.prod(shape)
        fan_in = numel // shape[0] if shape else 1
        if kind == "normal_fan_in":
            t = normal[off: off + numel] * math.sqrt(float(args[0]) / fan_in)
        elif kind == "uniform":
            lo, hi = float(args[0]), float(args[1])
            t = lo + uniform[off: off + numel] * (hi - lo)
        elif kind == "uniform_fan_in":
            b = 1.0 / math.sqrt(fan_in)
            t = -b + uniform[off: off + numel] * (2 * b)
        elif kind in ("zeros", "ones", "const"):
            v = {"zeros": 0.0, "ones": 1.0}.get(kind, float(args[0]) if args else 0.0)
            t = torch.full((numel,), v, device=device)
        else:
            raise ValueError(f"unknown init kind {kind!r} for {mod}.{name}")
        states[mod][name] = t.reshape(shape)
    return states
