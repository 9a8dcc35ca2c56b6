#!/usr/bin/env python3
"""Time another checkout's denseblock and conv3x3 kernels at every path
shape on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 denseblock_probe.py [--root DIR]

It runs ``chip_smoke.check_denseblock`` and ``chip_smoke.check_conv3x3``
on the wrappers of the checkout at ``DIR`` (default: this one), so an
older tree is timed by the same code, one line a shape and the sums over
a served step.  The two kernels share one conv mainloop
(``csrc/conv3x3_wgmma.cuh``).  A denseblock wrapper without
``pack_dense_bn`` takes HWIO kernels and BN pairs only, and is called
with those, as its FAN called it.
"""

from __future__ import annotations

import argparse
import sys

import chip_smoke


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None, help="checkout to import ppvision_tpu_torch from")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, args.root)

    import torch

    if not torch.cuda.is_available():
        print("denseblock_probe: no CUDA device", file=sys.stderr)
        return 2
    from ppvision_tpu_torch.ops import denseblock

    print(chip_smoke.card_line())
    print(f"ppvision_tpu_torch from {denseblock.__file__}")
    torch.set_grad_enabled(False)
    packed = hasattr(denseblock, "pack_dense_bn")
    dev = torch.device("cuda")
    chip_smoke.check_denseblock(torch, dev, chip_smoke.fan_args if packed else lambda ks, bns: (*ks, *bns))
    chip_smoke.check_conv3x3(torch, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
