#!/usr/bin/env python3
"""Split the conv3x3 kernel's time between its loads and its products.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 conv3x3_probe.py

Each variant is ``ppvision_tpu_torch/csrc/winograd.cu`` on its mainloop,
``csrc/conv3x3_wgmma.cuh``, with one part of the stage loop taken out;
the first is the source as it stands:

- "no MMAs": the loop loads every stage but issues no ``wgmma``;
- "no loads": after the prologue the loop loads nothing and waits only
  for the prologue's weights, so its products read whatever the buffers
  hold;
- "MMAs only": no waits, barriers or loads in the loop at all.

Only the committed source computes the conv; the others are for timing.
Every variant is built with the kernels' own flags into
``ppvision_tpu_torch/_build/probe/`` and timed at the eleven shapes of
``chip_smoke.CONV3X3_SHAPES`` by ``torch.profiler`` (device time of the
kernel, the mean over 20 launches) and by ``chip_smoke.cuda_ms``.  The
last line is one JSON object with every variant's device times.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import shutil
import subprocess
import sys

LOOP_LINES = {
    "wait": "    cp_async_wait<kD - 3>();  // stage u has landed; later ones may be in flight\n",
    "fence": '    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");  // visible to wgmma\n',
    "issue": "    issue(u + kD - 2);  // into the buffers of stage u - 2, whose wgmmas have retired\n",
    "mbar": "    mbar_wait(bars + 8 * (u % kD), (u / kD) % 2);  // stage u's weights have landed\n",
    "mma": "      for (int i = 0; i < MT; ++i) wgmma(acc[i], da[kk][i], db[kk], u > 0 || kk > 0);\n",
}
VARIANTS = {
    "as committed": (),
    "no MMAs": ("mma",),
    "no loads": ("issue", "mbar"),
    "MMAs only": ("wait", "fence", "issue", "mbar", "barrier"),
}


def variant_source(base: str, drop: tuple) -> str:
    loop = base.index("  for (int u = 0; u < T; ++u) {")
    head, body = base[:loop], base[loop:]
    for name in drop:
        if name == "barrier":
            line = "    __syncthreads();\n"
            body = body.replace(line, "", 1)
            continue
        if body.count(LOOP_LINES[name]) != 1:
            raise ValueError(f"csrc/conv3x3_wgmma.cuh's stage loop has no single {name!r} line")
        keep = {
            "mma": "      for (int i = 0; i < MT; ++i) {}\n",
            # The prologue's bulk copies must still land before the block exits.
            "mbar": "    if (u < kD - 2) mbar_wait(bars + 8 * (u % kD), (u / kD) % 2);\n",
        }.get(name, "")
        body = body.replace(LOOP_LINES[name], keep)
    return head + body


def build_variants(probe_dir: str) -> dict:
    """One nvcc per variant, all at once; returns the loaded libraries.
    Variant i is ``winograd.cu`` beside its own copy of the mainloop
    header in ``probe_dir/v<i>/``, which its quoted include finds first."""
    from ppvision_tpu_torch.ops import _build
    from ppvision_tpu_torch.ops.winograd import _SIGS

    with open(os.path.join(_build.CSRC, "conv3x3_wgmma.cuh")) as f:
        base = f.read()
    jobs = {}
    for i, (name, drop) in enumerate(VARIANTS.items()):
        vdir = os.path.join(probe_dir, f"v{i}")
        os.makedirs(vdir, exist_ok=True)
        with open(os.path.join(vdir, "conv3x3_wgmma.cuh"), "w") as f:
            f.write(variant_source(base, drop))
        cu = os.path.join(vdir, "winograd.cu")
        shutil.copyfile(os.path.join(_build.CSRC, "winograd.cu"), cu)
        cmd = [_build._nvcc(), *_build._FLAGS, "-I", _build.CSRC, "-o", cu[:-3] + ".so", cu]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (cu[:-3] + ".so", proc)
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.conv3x3.argtypes = _SIGS["conv3x3"]
        lib.conv3x3.restype = ctypes.c_int
        libs[name] = lib
    return libs


def device_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of the conv3x3 kernel over `iters` calls of fn."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages() if "conv3x3_kernel" in e.key)
    return total / iters / 1e3


def main() -> int:
    import torch

    import chip_smoke
    from ppvision_tpu_torch.ops import _build
    from ppvision_tpu_torch.ops.winograd import conv3x3, conv3x3_ref, pack_conv3x3_weight

    if not torch.cuda.is_available():
        print("conv3x3_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    card = chip_smoke.card_line()
    print(card)
    probe_dir = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(probe_dir, exist_ok=True)
    libs = build_variants(probe_dir)
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator().manual_seed(3)
    result = {name: {} for name in libs}
    for b, h, c, k in chip_smoke.CONV3X3_SHAPES:
        x = torch.randn((b, h, h, c), generator=g).to("cuda", torch.bfloat16)
        w = (torch.randn((3, 3, c, k), generator=g) / math.sqrt(9 * c)).to("cuda", torch.bfloat16)
        wp = pack_conv3x3_weight(w)
        out = torch.empty((b, h, h, k), dtype=torch.bfloat16, device="cuda")
        want = conv3x3(x, wp)
        for name, lib in libs.items():
            def call(lib=lib, name=name):
                err = lib.conv3x3(x.data_ptr(), wp.data_ptr(), out.data_ptr(), b, h, h, c, k, stream)
                if err:
                    raise RuntimeError(f"conv3x3 variant {name!r}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            if name == "as committed" and not torch.equal(out, want):
                raise AssertionError("the committed source built here disagrees with the package's kernel")
            dev, wall = device_ms(torch, call), chip_smoke.cuda_ms(call)
            result[name][f"{b}x{h}x{h}x{c}->{k}"] = dev
            print(f"{name:>12} B={b} {h}x{h} {c}->{k}: device {dev:.4f} ms, events {wall:.4f} ms")
        ref = conv3x3_ref(x, w).float()
        rel = float((want.float() - ref).abs().max()) / float(ref.abs().max())
        if not rel < 2e-2:
            raise AssertionError(f"conv3x3 disagrees with its plain version at {(b, h, c, k)}: rel {rel}")
    print(card)
    print(json.dumps({"card": card, "device_ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
