#!/usr/bin/env python3
"""Where the corr kernel's time goes (``csrc/corr.cu``) at RAFT's four
level shapes on one GPU, or another checkout's corr kernel timed there.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 corr_probe.py [--root DIR]

Inputs: B=30 pairs, 32x32 queries, C=256, r=4, fmap2 32^2 .. 4^2 (the
video path's levels); coords of the grid plus +-6 px, divided by 2^l as
``chip_smoke.check_corr`` makes them, and of the grid alone (RAFT's
smooth flow).  With ``--root DIR`` it times DIR's ``local_corr`` (a
20-call window and the profiler's device microseconds) and stops.
Otherwise it builds into ``ppvision_tpu_torch/_build/probe/`` the source
as it stands and three variants of it:

- "no products": every step stages its chunk, and nothing is computed;
- "no staging": after the first step nothing more is loaded;
- "clocks": the source with ``clock64()`` reads that record, per block,
  the cycles of its prologue, of issuing the copies of each step, of
  waiting for them, of the products and of the epilogue;

and prints each variant's device microseconds at each level, and the
clocks' mean over blocks.  Only the committed source computes the
result; the others are for timing.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import os
import subprocess
import sys

import numpy as np

B, H, C, R = 30, 32, 256, 4

COMPUTE = "    if (works) {\n      const Step st = step_of(s);"
VARIANTS = {
    "as committed": [],
    "no products": [(COMPUTE, "    if (works && nsteps < 0) {\n      const Step st = step_of(s);")],
    "no staging": [("    if (s + 1 < nsteps) {\n      issue(s + 1);",
                    "    if (s + 1 < nsteps && s < 0) {\n      issue(s + 1);")],
    "clocks": [
        ("namespace {\n", "__device__ long long g_clocks[6 * 8192];\n"
         "PPV_EXPORT int corr_clocks(void* dst, int n) { return cudaMemcpyFromSymbol(dst, g_clocks, n * 48); }\n"
         "namespace {\n"),
        ("  const int tid = threadIdx.x;\n", "  const int tid = threadIdx.x;\n  const long long t_start = clock64();\n"),
        ("  if (nsteps > 0) issue(0);\n",
         "  long long t0 = clock64(), c_wait = 0, c_comp = 0, c_issue = 0;\n"
         "  const long long c_pro = t0 - t_start;\n  if (nsteps > 0) issue(0);\n"),
        ("    if (s + 1 < nsteps) {\n      issue(s + 1);",
         "    if (s + 1 < nsteps) {\n      const long long ti = clock64();\n      issue(s + 1);\n"
         "      c_issue += clock64() - ti;"),
        ("      cp_async_wait<0>();\n    }\n    __syncthreads();\n    if (works) {",
         "      cp_async_wait<0>();\n    }\n    __syncthreads();\n    const long long ta = clock64();\n"
         "    c_wait += ta - t0;\n    if (works) {"),
        ("    __syncthreads();\n  }\n\n  // Epilogue", "    __syncthreads();\n    t0 = clock64();\n    c_comp += t0 - ta;\n  }\n\n  // Epilogue"),
        ("\n}\n\n}  // namespace",
         "\n  if (tid == 0) {\n    long long* g = g_clocks + 6 * (blockIdx.y * gridDim.x + blockIdx.x);\n"
         "    g[0] = c_pro; g[1] = c_issue; g[2] = c_wait - c_issue; g[3] = c_comp; g[4] = clock64() - t0;\n"
         "    g[5] = nsteps;\n  }\n}\n\n}  // namespace"),
    ],
}
PHASES = ("prologue", "issue", "wait", "products", "epilogue")


def inputs(torch):
    """fmap1, then per level (fmap2, [(name, coords)]) on the card."""
    rng = np.random.default_rng(4)
    f1 = torch.from_numpy(rng.standard_normal((B, H, H, C), dtype=np.float32)).cuda()
    ys, xs = np.meshgrid(np.arange(H), np.arange(H), indexing="ij")
    grid = np.stack([xs, ys], -1).astype(np.float32)
    levels = []
    for lvl in range(4):
        h2 = H >> lvl
        f2 = torch.from_numpy(rng.standard_normal((B, h2, h2, C), dtype=np.float32)).cuda()
        spread = (grid + rng.uniform(-6, 6, (B, H, H, 2)).astype(np.float32)) / 2**lvl
        smooth = np.broadcast_to(grid / 2**lvl, (B, H, H, 2)).copy()
        levels.append((f2, [(name, torch.from_numpy(co).cuda()) for name, co in (("+-6 px", spread), ("grid", smooth))]))
    return f1, levels


def build(variants) -> dict:
    """One nvcc per variant, all at once; returns the loaded libraries."""
    from ppvision_tpu_torch.ops import _build
    from ppvision_tpu_torch.ops.corr import _SIGS

    with open(os.path.join(_build.CSRC, "corr.cu")) as f:
        base = f.read()
    out_dir = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for i, (name, edits) in enumerate(variants.items()):
        src = base
        for old, new in edits:
            if src.count(old) != 1:
                raise ValueError(f"csrc/corr.cu has no single {old[:40]!r} for variant {name!r}")
            src = src.replace(old, new)
        # Beside the kernel's own source, so that its include of common.cuh resolves.
        path = os.path.join(_build.CSRC, f"_probe_corr_{i}.cu")
        with open(path, "w") as f:
            f.write(src)
        lib = os.path.join(out_dir, f"corr_{i}.so")
        cmd = [_build._nvcc(), *_build._FLAGS, "-o", lib, path]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), path, lib)
    libs = {}
    for name, (proc, path, lib) in jobs.items():
        log, _ = proc.communicate()
        os.remove(path)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name!r} variant:\n{log}")
        print(name, "|", " ".join(ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln))
        libs[name] = ctypes.CDLL(lib)
        libs[name].local_corr.argtypes = _SIGS["local_corr"]
        libs[name].local_corr.restype = ctypes.c_int
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None, help="checkout whose local_corr to time")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))

    import torch

    import chip_smoke
    from ppvision_tpu_torch.ops.corr import local_corr, local_corr_ref

    if not torch.cuda.is_available():
        print("corr_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    print(chip_smoke.card_line())
    f1, levels = inputs(torch)
    if args.root:
        for lvl, (f2, cases) in enumerate(levels):
            for name, coords in cases:
                fn = lambda: local_corr(f1, f2, coords, R)  # noqa: E731
                print(f"{args.root} level {lvl} {name}: {chip_smoke.cuda_ms(fn):.4f} ms, "
                      f"{chip_smoke.device_us(fn, 'corr'):.2f} us on the device")
        return 0

    from ppvision_tpu_torch.ops.corr import plan_corr

    libs = build(VARIANTS)
    out = torch.empty((B, H, H, (2 * R + 1) ** 2), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for lvl, (f2, cases) in enumerate(levels):
        h2 = H >> lvl
        plan = plan_corr(B, H * H, C, h2, h2, R)
        blocks = B * -(-H * H // plan.qb)
        for name, coords in cases:
            def call(lib):
                err = lib.local_corr(f1.data_ptr(), f2.data_ptr(), coords.data_ptr(), out.data_ptr(), B, H * H,
                                     h2, h2, C, R, plan.qb, plan.cw, plan.cap, stream)
                if err:
                    raise RuntimeError(f"local_corr returned CUDA error {err}")

            call(libs["as committed"])
            err = float((out - local_corr_ref(f1, f2, coords, R)).abs().max())
            times = {v: chip_smoke.device_us(lambda: call(lib), "corr_band") for v, lib in libs.items()}
            print(f"level {lvl} {name} {plan}: max_abs_err {err:.2e}; device us "
                  + ", ".join(f"{v} {t:.1f}" for v, t in times.items()))
            call(libs["clocks"])
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * (6 * blocks))()
            if libs["clocks"].corr_clocks(ctypes.cast(buf, ctypes.c_void_p), blocks):
                raise RuntimeError("corr_clocks failed")
            a = np.frombuffer(buf, dtype=np.int64).reshape(blocks, 6)
            mean = a[:, :5].mean(0)
            print(f"level {lvl} {name}: cycles a block ({blocks} blocks, {a[:, 5].mean():.0f} steps): "
                  + ", ".join(f"{p} {m:.0f} ({m / mean.sum():.0%})" for p, m in zip(PHASES, mean)))
    return 0 if math.isfinite(err) else 1


if __name__ == "__main__":
    sys.exit(main())
