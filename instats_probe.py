#!/usr/bin/env python3
"""Time the instats kernel (``ops/instats.py``) at every path shape on one
GPU: another checkout's wrapper, or a sweep of the kernel's plans.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 instats_probe.py [--root DIR]
    python3 instats_probe.py --sweep

Without ``--sweep`` it runs ``chip_smoke.check_instats`` on the wrapper
of the checkout at ``DIR`` (default: this one), so an older tree is
timed by the same code, one line a shape.  ``--sweep`` times, at each
shape of ``chip_smoke.INSTATS_SHAPES``, the kernel's device time under
each plan of a grid (S pixel chunks x channel slices) beside the plan
``plan_split`` picks, each plan checked against the plain version
first; the last line is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import chip_smoke

SPLITS = (1, 2, 4, 8, 16, 32, 64, 128)
SLICES = (1, 2, 4, 8, 16, 32)
MIN_SLICE_BYTES = 32  # narrowest slice the sweep tries, bytes a pixel
BLOCK_BYTES = (4 << 10, 1 << 20)  # bytes a block reads, least and most


def plans(b: int, hw: int, c: int, esize: int) -> list[tuple[int, int, int]]:
    """(S, chunk, slices) on the grid, as the kernel takes them."""
    row = c * esize
    out = []
    for d in SLICES:
        if d > 1 and (row % (16 * d) or row // d < MIN_SLICE_BYTES):
            continue
        for s in SPLITS:
            per_block = hw * row // (s * d)
            if s > hw or not BLOCK_BYTES[0] <= per_block <= BLOCK_BYTES[1]:
                continue
            chunk = -(-hw // s)
            plan = (-(-hw // chunk), chunk, d)
            if plan not in out:
                out.append(plan)
    return out


def sweep(torch, card: str) -> None:
    from ppvision_tpu_torch.ops import instats

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for (b, h, c), per_step in chip_smoke.INSTATS_SHAPES.items():
        x = torch.randn((b, h, h, c), generator=g, device=dev, dtype=torch.bfloat16)
        rm, rm2 = instats._moments_ref(x)
        picked = instats.plan_split(b, h * h, c, x.element_size())
        times = {}
        for plan in [picked] + [p for p in plans(b, h * h, c, x.element_size()) if p != picked]:
            m, m2 = instats._launch(x, *plan)
            err = max(float((m - rm).abs().max()), float((m2 - rm2).abs().max()))
            if not err <= 1e-5:
                raise AssertionError(f"plan {plan} disagrees with the plain version at {(b, h, c)}: {err}")
            times[plan] = chip_smoke.device_us(lambda: instats._launch(x, *plan), "moments_kernel")
        best = min(times, key=lambda p: (math.isnan(times[p]), times[p]))  # NaN: not measured
        rows.append(dict(shape=[b, h, h, c], per_step=per_step, picked=list(picked), picked_us=times[picked],
                         best=list(best), best_us=times[best],
                         plans=[[*p, t] for p, t in times.items()]))
        print(f"instats B={b} {h}x{h}x{c}: picked S={picked[0]} slices={picked[2]} {times[picked]:.2f} us; "
              f"best S={best[0]} slices={best[2]} {times[best]:.2f} us of {len(times)} plans")
        del x, rm, rm2
    step = {k: sum(r["per_step"] * r[k] for r in rows) for k in ("picked_us", "best_us")}
    print(f"a served step's {chip_smoke.INSTATS_PER_STEP} launches on the device: picked plans "
          f"{step['picked_us'] / 1e3:.4f} ms, best plans {step['best_us'] / 1e3:.4f} ms")
    print(json.dumps({"card": card, "step_us": step, "shapes": rows}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None, help="checkout to import ppvision_tpu_torch from")
    ap.add_argument("--sweep", action="store_true", help="time a grid of plans instead")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, args.root)

    import torch

    if not torch.cuda.is_available():
        print("instats_probe: no CUDA device", file=sys.stderr)
        return 2
    from ppvision_tpu_torch.ops import instats

    card = chip_smoke.card_line()
    print(card)
    print(f"ppvision_tpu_torch from {instats.__file__}")
    torch.set_grad_enabled(False)
    if args.sweep:
        sweep(torch, card)
    else:
        chip_smoke.check_instats(torch, torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
