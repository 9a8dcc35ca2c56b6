#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ppvision_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

What it does, in order; any failure raises and exits non-zero:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``ppvision_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once) and prints the build seconds and what
   ``ptxas -v`` reports;
3. runs each of the four kernels against its plain PyTorch version on
   the card at the shapes the de-id path gives it, checks the error
   against the stated tolerance, and times the kernel, the plain
   version and one library call that computes the same function;
4. builds the 128x128 full-width configuration with seeded random
   weights and serves a few requests through ``DeIdServer`` (batch 8,
   R = 10 styles), with every kernel's launch count set to 0 just before
   and read just after: each kernel must have run;
5. holds a B=2, R=2 GPU run against the port's own CPU run on the same
   weights and inputs (float32 and bfloat16 compute);
6. prints de-id images/s of ``deid_multi_style`` timed with CUDA events.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_S = 3.35e12  # H100 SXM HBM3
BF16_FLOP_S = 989e12  # dense bf16 tensor-core peak
F32_FLOP_S = 67e12  # f32 outside the tensor cores
IMG = 128
R_STYLES = 10
SERVE_BATCH = 8


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float, peak: float) -> tuple[float, str]:
    """Least time on the card: the larger of bytes over HBM rate and
    operations over the peak rate of their type (milliseconds)."""
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_fftconv(torch, dev) -> dict:
    from ppvision_tpu_torch.ops.fftconv import fftconv_circular, fftconv_circular_ref
    from ppvision_tpu_torch.optics.camera import Camera, CameraSpec, compute_psf, make_camera_constants

    worst = 0.0
    for n, b in ((IMG, SERVE_BATCH), (256, 2)):
        spec = CameraSpec(n=n)
        psf = compute_psf(Camera(spec).to(dev), make_camera_constants(spec, dev)).psf
        kern = torch.roll(psf, (-(n // 2), -(n // 2)), (0, 1))
        otf = torch.fft.fft2(kern, dim=(0, 1))
        ore, oim = otf.real.contiguous(), otf.imag.contiguous()
        img = torch.rand((b, n, n, 3), generator=torch.Generator().manual_seed(n)).to(dev)
        got = fftconv_circular(img, ore, oim)
        want = fftconv_circular_ref(img, ore, oim)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = 2e-5 * max(1.0, float(want.abs().max()))
        print(f"fftconv n={n} B={b}: max_abs_err {err:.3e} (tol {tol:.1e})")
        if not err <= tol:
            raise AssertionError(f"fftconv kernel disagrees with torch.fft at n={n}: {err} > {tol}")
        if n == IMG:
            worst, args = err, (img, ore, oim)
    img, ore, oim = args
    b, n, _, c = img.shape
    otf_half = torch.complex(ore, oim)[:, : n // 2 + 1]

    def library():
        spec = torch.fft.rfft2(img, dim=(1, 2)) * otf_half
        return torch.fft.irfft2(spec, s=(n, n), dim=(1, 2))

    nbytes = 4 * (2 * b * n * n * c + 2 * n * n * c)
    ops = b * c * (10 * n * n * math.log2(n * n) + 6 * n * n)
    bms, by = bound(nbytes, ops, F32_FLOP_S)
    return dict(
        name="fftconv", route="cuda", source="ppvision_tpu_torch/csrc/fftconv.cu",
        replaces="ppvision_tpu/ops/fftconv.py:69", max_abs_err=worst,
        ms=cuda_ms(lambda: fftconv_circular(img, ore, oim)),
        plain_ms=cuda_ms(lambda: fftconv_circular_ref(img, ore, oim)),
        bound_ms=bms, bound_by=by, library_ms=cuda_ms(library),
        shape=[b, n, n, c], tolerance="max_abs_err <= 2e-5 * max(1, max|plain|)",
    )


def check_denseblock(torch, dev) -> dict:
    from ppvision_tpu_torch.ops.denseblock import dense_block_ref, fused_dense_block

    g = torch.Generator().manual_seed(1)

    def make(b, h, f):
        half, q = f // 2, f // 4
        x = torch.randn((b, h, h, f), generator=g).to(dev, torch.bfloat16)
        ks = [
            (torch.randn(shape, generator=g) * (1.0 / math.sqrt(9 * shape[2]))).to(dev, torch.bfloat16)
            for shape in ((3, 3, f, half), (3, 3, half, q), (3, 3, q, q))
        ]
        bns = [
            ((1 + 0.1 * torch.randn(c, generator=g)).to(dev), (0.1 * torch.randn(c, generator=g)).to(dev))
            for c in (f, half, q)
        ]
        return x, ks, bns

    worst = 0.0
    # The FAN path's shapes: F=128 at 64^2, F=256 at 64^2 .. 4^2.
    for f, h in ((128, 64), (256, 64), (256, 32), (256, 16), (256, 8), (256, 4)):
        x, ks, bns = make(SERVE_BATCH, h, f)
        got = fused_dense_block(x, *ks, *bns).float()
        want = dense_block_ref(x, *ks, *bns).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / (float(want.abs().max()) + 1e-8)
        print(f"denseblock F={f} {h}x{h}: max_abs_err {err:.3e} rel {rel:.3e} (tol rel 2e-2)")
        if not rel < 2e-2:
            raise AssertionError(f"denseblock kernel disagrees with its plain version: rel {rel}")
        if (f, h) == (256, 64):
            worst, args = err, (x, ks, bns)
    x, ks, bns = args
    b, h, w, f = x.shape
    macs = b * h * w * 9 * (f * f // 2 + f // 2 * f // 4 + f // 4 * f // 4)
    nbytes = 2 * (2 * x.numel() + sum(k.numel() for k in ks)) + 4 * 6 * f
    bms, by = bound(nbytes, 2 * macs, BF16_FLOP_S)
    return dict(
        name="denseblock", route="cuda", source="ppvision_tpu_torch/csrc/denseblock.cu",
        replaces="ppvision_tpu/ops/denseblock.py:124", max_abs_err=worst,
        ms=cuda_ms(lambda: fused_dense_block(x, *ks, *bns)),
        plain_ms=cuda_ms(lambda: dense_block_ref(x, *ks, *bns)),
        bound_ms=bms, bound_by=by, library_ms=None,
        shape=[b, h, w, f], tolerance="max_abs_err / max|plain| < 2e-2 (bf16 conv error scale)",
    )


def check_instats(torch, dev) -> dict:
    from ppvision_tpu_torch.ops.instats import _moments_ref, instance_moments

    g = torch.Generator().manual_seed(2)
    worst = 0.0
    # Encoder/decoder InstanceNorm shapes at 128^2, batch 8.
    for h, c in ((128, 128), (64, 256), (32, 512), (16, 512), (8, 512)):
        x = torch.randn((SERVE_BATCH, h, h, c), generator=g).to(dev, torch.bfloat16)
        m, m2 = instance_moments(x)
        rm, rm2 = _moments_ref(x)
        torch.cuda.synchronize()
        err = max(float((m - rm).abs().max()), float((m2 - rm2).abs().max()))
        print(f"instats {h}x{h}x{c}: max_abs_err {err:.3e} (tol 1e-5)")
        if not err <= 1e-5:
            raise AssertionError(f"instats kernel disagrees with its plain version: {err}")
        if (h, c) == (128, 128):
            worst, big = err, x
    x = big
    b, h, w, c = x.shape
    nbytes = 2 * x.numel() + 2 * 4 * b * c
    bms, by = bound(nbytes, 3 * x.numel(), F32_FLOP_S)
    return dict(
        name="instats", route="triton", source="ppvision_tpu_torch/ops/instats.py",
        replaces="ppvision_tpu/ops/instats.py:66", max_abs_err=worst,
        ms=cuda_ms(lambda: instance_moments(x)),
        plain_ms=cuda_ms(lambda: _moments_ref(x)),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: torch.var_mean(x, dim=(1, 2), correction=0)),
        shape=[b, h, w, c], tolerance="max_abs_err <= 1e-5 on both moments",
    )


def check_conv3x3(torch, dev) -> dict:
    import torch.nn.functional as F

    from ppvision_tpu_torch.ops.winograd import conv3x3, conv3x3_ref

    g = torch.Generator().manual_seed(3)
    shapes = [  # (B, H, C, K): generator encode/decode and style encoder
        (8, 64, 128, 256), (8, 32, 256, 512), (8, 16, 512, 512), (8, 8, 512, 512),
        (8, 128, 128, 128), (8, 64, 256, 256), (8, 32, 512, 512), (10, 4, 512, 512),
    ]
    worst = 0.0
    for b, h, c, k in shapes:
        x = torch.randn((b, h, h, c), generator=g).to(dev, torch.bfloat16)
        w = (torch.randn((3, 3, c, k), generator=g) / math.sqrt(9 * c)).to(dev, torch.bfloat16)
        got = conv3x3(x, w).float()
        want = conv3x3_ref(x, w).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / (float(want.abs().max()) + 1e-8)
        print(f"conv3x3 B={b} {h}x{h} {c}->{k}: max_abs_err {err:.3e} rel {rel:.3e} (tol rel 2e-2)")
        if not rel < 2e-2:
            raise AssertionError(f"conv3x3 kernel disagrees with F.conv2d: rel {rel}")
        if (h, c, k) == (128, 128, 128):
            worst, args = err, (x, w)
    x, w = args
    b, h, wd, c = x.shape
    k = w.shape[-1]
    x_cl = x.permute(0, 3, 1, 2)
    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    nbytes = 2 * (2 * x.numel() + w.numel())
    bms, by = bound(nbytes, 2 * 9 * b * h * wd * c * k, BF16_FLOP_S)
    return dict(
        name="conv3x3", route="cuda", source="ppvision_tpu_torch/csrc/winograd.cu",
        replaces="ppvision_tpu/ops/winograd.py:99", max_abs_err=worst,
        ms=cuda_ms(lambda: conv3x3(x, w)),
        plain_ms=cuda_ms(lambda: conv3x3_ref(x, w)),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: F.conv2d(x_cl, w_oihw, padding=1)),
        shape=[b, h, wd, c, k], tolerance="max_abs_err / max|plain| < 2e-2 (bf16 conv error scale)",
    )


def seeded_inputs(b: int, r: int):
    import torch

    rng = np.random.default_rng(7)
    x_src = torch.from_numpy(rng.random((b, IMG, IMG, 3), dtype=np.float32))
    x_ref = torch.from_numpy(rng.random((r, IMG, IMG, 3), dtype=np.float32))
    y_ref = torch.from_numpy(np.arange(r) % 2)
    return x_src, x_ref, y_ref


def config(dtype: str):
    from ppvision_tpu_torch.config import CameraConfig, FaceDeIdConfig, ModelConfig

    return FaceDeIdConfig(model=ModelConfig(img_size=IMG, compute_dtype=dtype), camera=CameraConfig(n=IMG))


def serve_main_path(torch, kernels) -> dict:
    from ppvision_tpu_torch.deid import build_deid
    from ppvision_tpu_torch.serve import DeIdServer

    bundle = build_deid(0, config("bfloat16"), device="cuda")
    rng = np.random.default_rng(11)
    x_ref = rng.random((R_STYLES, IMG, IMG, 3), dtype=np.float32)
    y_ref = np.arange(R_STYLES) % 2
    server = DeIdServer(bundle, x_ref, y_ref, batch_size=SERVE_BATCH, depth=2)
    server.warmup()
    requests = [rng.random((IMG, IMG, 3), dtype=np.float32) for _ in range(3 * SERVE_BATCH - 3)]
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    outs = list(server.serve(requests))
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    print(f"served {len(outs)} requests in {wall:.3f} s; launches {launches}; stats {server.stats()}")
    if len(outs) != len(requests):
        raise AssertionError(f"{len(outs)} outputs for {len(requests)} requests")
    for o in outs:
        if o.shape != (R_STYLES, IMG, IMG, 3) or not np.isfinite(o).all():
            raise AssertionError(f"bad output: shape {o.shape}, finite {np.isfinite(o).all()}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    return launches


def gpu_vs_cpu(torch) -> None:
    """B=2, R=2 on the card against the port's CPU path, same weights."""
    from ppvision_tpu_torch.deid import build_deid, deid_multi_style

    xs, xr, yr = seeded_inputs(2, 2)
    out = {}
    for dtype in ("float32", "bfloat16"):
        for dev in ("cuda", "cpu"):
            b = build_deid(0, config(dtype), device=dev)
            t0 = time.perf_counter()
            out[dtype, dev] = deid_multi_style(b, xs, xr, yr).cpu().numpy()
            print(f"deid_multi_style {dtype} on {dev}: {time.perf_counter() - t0:.2f} s")
    ref = out["float32", "cpu"]
    scale = max(1.0, float(np.abs(ref).max()))
    d32 = np.abs(out["float32", "cuda"] - ref)
    print(f"f32 GPU vs CPU: max {d32.max():.3e} p99 {np.quantile(d32, 0.99):.3e} (|out| max {scale:.2f})")
    # True-f32 math on both sides (TF32 off); differences are summation
    # order through ~60 layers, so the bound is relative to the output scale.
    if not d32.max() <= 2e-3 * scale:
        raise AssertionError(f"float32 GPU run disagrees with the CPU run: {d32.max()}")
    # bf16 rounds at the same ops on both sides, but a 1-ulp change in a
    # conv sum propagates through the random-weight nets as far as bf16
    # itself departs from f32, so the GPU run must sit no further from the
    # CPU bf16 run than that run sits from the f32 one.
    noise = np.abs(out["bfloat16", "cpu"] - ref)
    d16 = np.abs(out["bfloat16", "cuda"] - out["bfloat16", "cpu"])
    for q, name in ((0.99, "p99"), (1.0, "max")):
        a, n = float(np.quantile(d16, q)), float(np.quantile(noise, q))
        print(f"bf16 GPU vs CPU {name} {a:.3e}; bf16 vs f32 on CPU {name} {n:.3e}")
        if not a <= 1.5 * n + 1e-3:
            raise AssertionError(f"bf16 GPU run departs from the CPU run: {name} {a} > 1.5 x {n}")


def throughput(torch, card: str) -> None:
    """img/s of deid_multi_style, and the device's busy share of a call
    from one profiled call (kernel time summed by torch.profiler)."""
    from ppvision_tpu_torch.deid import build_deid, deid_multi_style

    bundle = build_deid(0, config("bfloat16"), device="cuda")
    for b in (SERVE_BATCH, 32):
        xs, xr, yr = (t.cuda() for t in seeded_inputs(b, R_STYLES))
        ms = cuda_ms(lambda: deid_multi_style(bundle, xs, xr, yr), iters=3, warmup=1)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            deid_multi_style(bundle, xs, xr, yr)
            torch.cuda.synchronize()
        events = prof.key_averages()
        busy = sum(e.self_device_time_total for e in events) / 1e3
        print(json.dumps({
            "deid_multi_style_img_s": b * R_STYLES / (ms / 1e3), "B": b, "R": R_STYLES,
            "ms_per_call": ms, "device_busy_ms": busy, "device_idle_share": max(0.0, 1 - busy / ms),
            "img": IMG, "card": card,
        }))
    print(events.table(sort_by="self_device_time_total", row_limit=15, max_name_column_width=60))


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)

    import torch

    from ppvision_tpu_torch.ops import KERNELS, _build

    torch.set_grad_enabled(False)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card)
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    secs = _build.build_all()
    print(f"kernel build: {secs:.1f} s")
    for name in _build.CUDA_SOURCES:
        print(_build.ptxas_report(name), end="")

    records = [check_fftconv(torch, dev), check_denseblock(torch, dev),
               check_instats(torch, dev), check_conv3x3(torch, dev)]
    for r in records:
        print(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"by {r['bound_by']}, library {r['library_ms']})")
    launches = serve_main_path(torch, KERNELS)
    gpu_vs_cpu(torch)
    throughput(torch, card)

    for r in records:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(card)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
