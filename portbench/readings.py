"""Readings of a cell's comparison over many seeds, in one process.

    python3 -m portbench.readings --workload NAME --seconds S --seeds A,B,C [--variants -,fp8]

Runs the cell once for each seed and each variant (``-`` is the program
as the configuration states it; any other name is a control or a planted
fault of the cell's kind) through the same code as ``portbench.run``,
with a short window, and prints after each run's own lines one line
``{"reading": {seed, variant, correct, compared}}``.  The limits of a
configuration are set from these readings: the largest a sound seed
gives, the smallest a control gives.  One process pays the import and
the kernels' load once; every run builds its cell anew.  It needs the
card, as a cell's runs do; it prints no result line of a cell.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    from . import run

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--variants", default="-", help="comma-separated; '-' is the program as configured")
    a = p.parse_args(argv)
    import torch

    spec = run.load_spec()
    wl, _, _ = run.cell_files(spec, a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print("portbench.readings: the cell needs a CUDA device", file=sys.stderr)
        return 2
    for variant in a.variants.split(","):
        for seed in (int(s) for s in a.seeds.split(",")):
            v = None if variant == "-" else variant
            out = run.run(a.workload, seed, a.seconds, False, "cuda", v, spec=spec)
            print(json.dumps({"reading": {"seed": seed, "variant": variant, "correct": out["correct"],
                                          "compared": out["compared"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
