#!/usr/bin/env python3
"""Time variants of the fftconv kernel's design constants on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 fftconv_sweep.py

Each variant is ``ppvision_tpu_torch/csrc/fftconv.cu`` with one design
constant changed (threads a block, R rows a row block, Q columns a
column block); the first is the source as it stands.  Every variant is
built with the kernels' own flags into ``ppvision_tpu_torch/_build/sweep/``,
checked against the plain version and against the committed source's
output bit for bit, and timed with ``chip_smoke.cuda_ms`` at the two
paths' shapes (8x128x128x3 and 16x256x256x3), twice in turns (forwards,
then backwards), beside the rfft2 conv.  Last, ``torch.profiler`` gives
the device time of each of the committed source's three passes.  The
last line is one JSON object with every variant's times.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

VARIANTS = {
    "as committed": {},
    "128 threads": {"kThreads": 128},
    "512 threads": {"kThreads": 512},
    "R = 2": {"kLog2Rows": 1},
    "R = 8": {"kLog2Rows": 3},
    "Q = 8": {"kLog2Cols": 3},
    "Q = 32": {"kLog2Cols": 5},
}
SHAPES = ((8, 128, 3), (16, 256, 3))


def variant_source(base: str, consts: dict) -> str:
    for k, v in consts.items():
        base, n = re.subn(rf"constexpr int {k} = [^;]+;", f"constexpr int {k} = {v};", base)
        if n != 1:
            raise ValueError(f"csrc/fftconv.cu has no single definition of {k}")
    return base


def build_variants(sweep_dir: str) -> dict:
    """One nvcc per variant, all at once; returns the loaded libraries."""
    from ppvision_tpu_torch.ops import _build
    from ppvision_tpu_torch.ops.fftconv import _SIGS

    with open(os.path.join(_build.CSRC, "fftconv.cu")) as f:
        base = f.read()
    jobs = {}
    for i, (name, consts) in enumerate(VARIANTS.items()):
        cu = os.path.join(sweep_dir, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(base, consts))
        cmd = [_build._nvcc(), *_build._FLAGS, "-I", _build.CSRC, "-o", cu[:-3] + ".so", cu]
        jobs[name] = (cu[:-3] + ".so", subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.fftconv_circular.argtypes = _SIGS["fftconv_circular"]
        lib.fftconv_circular.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launcher(lib, img, ore, oim, tw, out, spec, stream):
    """One variant's C entry point bound to one shape's tensors."""
    b, n, _, c = img.shape
    return lambda: lib.fftconv_circular(img.data_ptr(), ore.data_ptr(), oim.data_ptr(), tw.data_ptr(),
                                        out.data_ptr(), spec.data_ptr(), b, n, c, stream)


def main() -> int:
    import torch

    from chip_smoke import card_line, cuda_ms, rfft_conv
    from ppvision_tpu_torch.ops import _build
    from ppvision_tpu_torch.ops.fftconv import _twiddles, fftconv_circular_ref

    if not torch.cuda.is_available():
        print("fftconv_sweep: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card)
    sweep_dir = os.path.join(_build.BUILD_DIR, "sweep")
    os.makedirs(sweep_dir, exist_ok=True)
    libs = build_variants(sweep_dir)

    dev = torch.device("cuda")
    results, committed_calls = {}, {}
    for b, n, c in SHAPES:
        shape = f"{b}x{n}x{n}x{c}"
        rng = np.random.default_rng(n)
        img = torch.from_numpy(rng.random((b, n, n, c), dtype=np.float32)).to(dev)
        otf = torch.fft.fft2(torch.from_numpy(rng.standard_normal((n, n, c)).astype(np.float32)).to(dev) / n,
                             dim=(0, 1))
        ore, oim = otf.real.contiguous(), otf.imag.contiguous()
        want = fftconv_circular_ref(img, ore, oim)
        tol = 2e-5 * max(1.0, float(want.abs().max()))
        out = torch.empty_like(img)
        spec = torch.empty((b * c + c, n, n, 2), device=dev)
        tw = _twiddles(n, dev)
        stream = torch.cuda.current_stream().cuda_stream

        variant_calls = {name: launcher(lib, img, ore, oim, tw, out, spec, stream) for name, lib in libs.items()}

        def call(name):
            err = variant_calls[name]()
            if err:
                raise RuntimeError(f"variant {name!r}: CUDA error {err}")

        committed = None
        for name in libs:
            call(name)
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            if not err <= tol:
                raise AssertionError(f"variant {name!r} at {shape}: max_abs_err {err} > {tol}")
            committed = out.clone() if committed is None else committed
            if not torch.equal(out, committed):
                raise AssertionError(f"variant {name!r} at {shape}: output differs from the committed source's")
            results.setdefault(name, {})[shape] = []
        lib_ms = []
        for order in (list(libs), list(libs)[::-1]):
            lib_ms.append(cuda_ms(lambda: rfft_conv(img, ore, oim)))
            for name in order:
                results[name][shape].append(cuda_ms(lambda: call(name)))
        for name in libs:
            print(f"{shape} {name}: {results[name][shape]} ms")
        print(f"{shape} rfft2 conv: {lib_ms} ms")
        results.setdefault("rfft2 conv", {})[shape] = lib_ms
        committed_calls[shape] = variant_calls["as committed"]

    # Device time of each pass of the committed source, profiled after all
    # the timing so that the profiler cannot slow the launches timed above.
    passes = {}
    for shape, fn in committed_calls.items():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        passes[shape] = {p: sum(e.self_device_time_total for e in events if p in e.key) / 20
                         for p in ("rows_forward", "columns", "rows_inverse")}
        print(f"{shape} as committed, device us a call by pass: {passes[shape]}")
    print(json.dumps({"card": card, "ms": results, "device_us_by_pass": passes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
