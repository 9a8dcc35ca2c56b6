#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ppvision_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

What it does, in order; any failure raises and exits non-zero:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``ppvision_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once) and prints the build seconds and what
   ``ptxas -v`` reports;
3. runs each of the five kernels against its plain PyTorch version on
   the card at the shapes the de-id path (128x128 and 256x256) and the
   video path's RAFT give it, checks the error against the stated
   tolerance, and times the kernel, the plain version and one library
   call that computes the same function, where there is one, beside the
   kernel's bound; fftconv gets one record at each path's shape;
   conv3x3, instats and denseblock are checked and timed at every shape
   either path gives them, with instats' and denseblock's device
   microseconds, instats' host microseconds a call, and the sums over a
   served step's 93, 145 and 15 launches; corr at each of RAFT's four
   levels and at a 64^2 map with coords spread over all of it, with its
   device microseconds and bound at each; two instats, two denseblock
   and two corr calls must agree bit for bit; ptxas may not have
   serialized any wgmma (C7513, C7515);
4. builds the 128x128 full-width configuration with seeded random
   weights and serves a few requests through ``DeIdServer`` (batch 8,
   R = 10 styles), with every launch count set to 0 just before and read
   just after: each of the four de-id kernels must have run, conv3x3
   exactly 93, instats 145 and denseblock 15 times a step, each instats
   and denseblock shape as often as ``INSTATS_SHAPES`` and
   ``DENSEBLOCK_SHAPES`` say; prints how many instats inputs had to be
   copied to be contiguous;
5. holds a B=2, R=2 GPU run against the port's own CPU run on the same
   weights and inputs (float32 and bfloat16 compute);
6. prints de-id images/s of ``deid_multi_style`` timed with CUDA events;
7. the video path at the reference's full size (``ModelConfig()``:
   256x256, bf16; full-size RAFT in f32, 4 levels, radius 4, 12
   iterations, ``alternate_corr=True``), as ``cli/main.py::run_video``
   drives it, on 16 seeded frames of a smooth image moving 1 px a frame:
   de-id with one fixed reference style, the style-interpolation video
   on 8 sources and 2 references, and ``flow_consistency`` over the 30
   frame pairs in one RAFT call; launch counts set to 0 just before and
   read just after: all five kernels must have run, the correlation
   kernel 4 levels x 12 iterations = 48 times; every instats and
   denseblock shape of both paths must be one that step 3 checked;
   instats' and corr's input copies; then the same phase again under
   ``torch.profiler``: its device busy milliseconds and instats' and
   denseblock's shares of them;
8. RAFT on the card: the alternate path against the dense path at the
   same weights (B=2, 256x256, 3 iterations), and against the port's
   CPU RAFT (B=1, 128x128, 3 iterations);
9. times the two RAFT convs it runs as unfold + matmul against cuDNN,
   and prints RAFT pairs/s (B=30, 256x256, 12 iterations; alternate and
   dense), the device's idle share of a call, the corr kernel's device
   milliseconds and launches in an alternate call beside 12 x its four
   levels' bounds, and the video phase's seconds.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
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
VIDEO_IMG = 256  # the reference's default: ModelConfig(), CameraConfig(n=256)
VIDEO_T = 16  # frames; flow_consistency pairs both sequences: 2 x 15 = 30
RAFT_ITERS = 12
RAFT_LEVELS = 4  # run_video's rule at 256^2: min(4, log2(256 / 8) + 1)
RAFT_RADIUS = 4
OUT_DIR = "chip_smoke_out"  # videos, where the machine has ffmpeg (listed in .gitignore)


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


def rfft_conv(img, ore, oim):
    """One library computation of the same circular conv: rfft2, the
    half-spectrum product, irfft2."""
    import torch

    n = img.shape[1]
    spec = torch.fft.rfft2(img, dim=(1, 2)) * torch.complex(ore, oim)[:, : n // 2 + 1]
    return torch.fft.irfft2(spec, s=(n, n), dim=(1, 2))


def check_fftconv(torch, dev) -> list[dict]:
    """Kernel 1 at both paths' shapes: the de-id camera (B=8, 128^2) and
    the video camera (B=16, 256^2); one record each."""
    from ppvision_tpu_torch.ops.fftconv import fftconv_circular, fftconv_circular_ref
    from ppvision_tpu_torch.optics.camera import Camera, CameraSpec, compute_psf, make_camera_constants

    records = []
    for n, b, path in ((IMG, SERVE_BATCH, "deid"), (VIDEO_IMG, VIDEO_T, "video")):
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
        c = img.shape[-1]
        nbytes = 4 * (2 * b * n * n * c + 2 * n * n * c)
        ops = b * c * (10 * n * n * math.log2(n * n) + 6 * n * n)
        bms, by = bound(nbytes, ops, F32_FLOP_S)
        records.append(dict(
            name="fftconv", route="cuda", source="ppvision_tpu_torch/csrc/fftconv.cu",
            replaces="ppvision_tpu/ops/fftconv.py:69", max_abs_err=err, path=path,
            ms=cuda_ms(lambda: fftconv_circular(img, ore, oim)),
            plain_ms=cuda_ms(lambda: fftconv_circular_ref(img, ore, oim)),
            bound_ms=bms, bound_by=by, library_ms=cuda_ms(lambda: rfft_conv(img, ore, oim)),
            shape=[b, n, n, c], tolerance="max_abs_err <= 2e-5 * max(1, max|plain|)",
        ))
    return records


def denseblock_bound(x, ks) -> tuple[float, str]:
    """x read once, the output written once, the weights, 2 x the MACs."""
    b, h, w, f = x.shape
    macs = b * h * w * 9 * (f * f // 2 + f // 2 * f // 4 + f // 4 * f // 4)
    return bound(2 * (2 * x.numel() + sum(k.numel() for k in ks)) + 4 * 6 * f, 2 * macs, BF16_FLOP_S)


# (B, H, F) of every DenseConvBlock FAN runs as kernel 2 (bf16, in = out
# features), with its launches per served de-id step: FAN runs at 256^2
# on the step's 8 sources, the stem's 128-wide block and top_m_0 at 64^2,
# the depth-4 hourglass's 13 blocks at 64^2 .. 4^2.  The video phase runs
# FAN on its 16 frames and on the interpolation video's 8 sources (the
# served shapes); none of that is in the served step.  The served run and
# the video phase check that they take no other shape.
DENSEBLOCK_SHAPES = {
    (8, 64, 128): 1, (8, 64, 256): 2, (8, 32, 256): 3, (8, 16, 256): 3, (8, 8, 256): 3, (8, 4, 256): 3,
    (VIDEO_T, 64, 128): 0, (VIDEO_T, 64, 256): 0, (VIDEO_T, 32, 256): 0, (VIDEO_T, 16, 256): 0,
    (VIDEO_T, 8, 256): 0, (VIDEO_T, 4, 256): 0,
}
DENSEBLOCK_PER_STEP = sum(DENSEBLOCK_SHAPES.values())  # 15


def fan_args(ks, bns) -> tuple:
    """The kernel's arguments after x as ``DenseConvBlock`` hands them
    over: the weights packed, the BN pairs in one (6, F) pack."""
    from ppvision_tpu_torch.ops.denseblock import pack_dense_bn
    from ppvision_tpu_torch.ops.winograd import pack_conv3x3_weight

    return (*[pack_conv3x3_weight(k) for k in ks], pack_dense_bn(bns, ks[0].shape[2]))


def check_denseblock(torch, dev, kernel_args=fan_args) -> dict:
    """Kernel 2 at every shape of ``DENSEBLOCK_SHAPES``, called with
    ``kernel_args(ks, bns)`` after x: error against the plain version
    (the cuDNN chain), the kernel's time in a 20-call window and on the
    device (its passes summed) beside the chain's and the bound, one line
    each, and the sums over a served step's 15 launches.  At 8x64x64x256
    two calls and the HWIO call must agree bit for bit; one record there."""
    from ppvision_tpu_torch.ops.denseblock import dense_block_ref, fused_dense_block

    g = torch.Generator(device=dev).manual_seed(1)
    step = {"ms": 0.0, "device_ms": 0.0, "chain_ms": 0.0}
    for (b, h, f), per_step in DENSEBLOCK_SHAPES.items():
        x = torch.randn((b, h, h, f), generator=g, device=dev, dtype=torch.bfloat16)
        ks = [(torch.randn(s, generator=g, device=dev) / math.sqrt(9 * s[2])).to(torch.bfloat16)
              for s in ((3, 3, f, f // 2), (3, 3, f // 2, f // 4), (3, 3, f // 4, f // 4))]
        bns = [(1 + 0.1 * torch.randn(c, generator=g, device=dev), 0.1 * torch.randn(c, generator=g, device=dev))
               for c in (f, f // 2, f // 4)]
        args = kernel_args(ks, bns)
        out = fused_dense_block(x, *args)
        want = dense_block_ref(x, *ks, *bns).float()
        torch.cuda.synchronize()
        err = float((out.float() - want).abs().max())
        rel = err / (float(want.abs().max()) + 1e-8)
        if not rel < 2e-2:
            raise AssertionError(f"denseblock kernel disagrees with its plain version at {(b, h, f)}: rel {rel}")
        del want
        row = dict(
            ms=cuda_ms(lambda: fused_dense_block(x, *args)),
            device_ms=device_us(lambda: fused_dense_block(x, *args), "denseblock") / 1e3,
            chain_ms=cuda_ms(lambda: dense_block_ref(x, *ks, *bns)),
        )
        bms, by = denseblock_bound(x, ks)
        for k in step:
            step[k] += per_step * row[k]
        print(f"denseblock B={b} {h}x{h}x{f}: {row['ms']:.4f} ms, {row['device_ms'] * 1e3:.2f} us on the device "
              f"(cuDNN chain {row['chain_ms']:.4f}, bound {bms:.4f} by {by}; {per_step} a served step); "
              f"max_abs_err {err:.3e} rel {rel:.3e} (tol rel 2e-2)")
        if (b, h, f) == (SERVE_BATCH, 64, 256):
            if not (torch.equal(fused_dense_block(x, *args), out) and torch.equal(fused_dense_block(x, *ks, *bns), out)):
                raise AssertionError("denseblock: two calls, or the packed and HWIO calls, differ")
            record = dict(
                name="denseblock", route="cuda", source="ppvision_tpu_torch/csrc/denseblock.cu",
                replaces="ppvision_tpu/ops/denseblock.py:124", max_abs_err=err, path="deid",
                ms=row["ms"], plain_ms=row["chain_ms"], bound_ms=bms, bound_by=by, library_ms=None,
                shape=[b, h, h, f], tolerance="max_abs_err / max|plain| < 2e-2 (bf16 conv error scale)",
            )
    print(f"denseblock over a served step's {DENSEBLOCK_PER_STEP} launches: kernel {step['ms']:.4f} ms, "
          f"{step['device_ms']:.4f} ms on the device, cuDNN chain {step['chain_ms']:.4f} ms")
    return record


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds a call of ``fn`` over ``calls`` calls that are
    not synchronised (the queue drains after the clock stops)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def device_us(fn, kernel: str, calls: int = 20) -> float:
    """Mean device microseconds of the kernels whose name holds ``kernel``
    (any case) over ``calls`` calls of ``fn``, from ``torch.profiler``;
    NaN where the profiler saw no such kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if kernel in e.key.lower()]
    return sum(e.self_device_time_total for e in events) / calls if events else math.nan


def instats_bound(x) -> tuple[float, str]:
    b, h, w, c = x.shape
    return bound(x.element_size() * x.numel() + 2 * 4 * b * c, 3 * x.numel(), F32_FLOP_S)


# (B, H, C) of every InstanceNorm/AdaIN moment the two paths take, bf16,
# with its launches per served de-id step at 128^2 (B = 8 sources, R =
# 10 styles: encode once, decode once a style).  The 256^2 generator
# runs in the video phase: de-id at the video's batch of 16, and the
# style-interpolation video, which encodes its 8 sources and decodes
# them under 31 styles at once (B = 248); none of that is in the served
# step.  The served run and the video phase check that they take no
# other shape.
INTERP_B = 8 * 31
INSTATS_SHAPES = {
    (8, 128, 128): 22, (8, 64, 128): 1, (8, 64, 256): 22, (8, 32, 256): 1, (8, 32, 512): 22,
    (8, 16, 512): 22, (8, 8, 512): 55,
    (VIDEO_T, 256, 64): 0, (VIDEO_T, 128, 64): 0, (VIDEO_T, 128, 128): 0, (VIDEO_T, 64, 128): 0,
    (VIDEO_T, 64, 256): 0, (VIDEO_T, 32, 256): 0, (VIDEO_T, 32, 512): 0, (VIDEO_T, 16, 512): 0,
    (VIDEO_T, 8, 512): 0,
    (8, 256, 64): 0, (8, 128, 64): 0,
    (INTERP_B, 256, 64): 0, (INTERP_B, 128, 128): 0, (INTERP_B, 64, 256): 0, (INTERP_B, 32, 512): 0,
    (INTERP_B, 16, 512): 0, (INTERP_B, 8, 512): 0,
}
INSTATS_PER_STEP = sum(INSTATS_SHAPES.values())  # 145


def check_instats(torch, dev) -> list[dict]:
    """Kernel 3 at every shape of ``INSTATS_SHAPES``: error against the
    plain version, the kernel's time in a 20-call window and on the
    device beside ``torch.var_mean`` and the bound, the host
    microseconds a call, one line each, and the sums over a served
    step's 145 launches.  Two calls at the video shape must agree bit
    for bit.  One record at each path's largest shape of the de-id and
    the video batch."""
    from ppvision_tpu_torch.ops.instats import _moments_ref, instance_moments

    g = torch.Generator(device=dev).manual_seed(2)
    records, step = [], {"ms": 0.0, "device_ms": 0.0, "var_mean_ms": 0.0}
    for (b, h, c), per_step in INSTATS_SHAPES.items():
        x = torch.randn((b, h, h, c), generator=g, device=dev, dtype=torch.bfloat16)
        m, m2 = instance_moments(x)
        rm, rm2 = _moments_ref(x)
        torch.cuda.synchronize()
        err = max(float((m - rm).abs().max()), float((m2 - rm2).abs().max()))
        if not err <= 1e-5:
            raise AssertionError(f"instats kernel disagrees with its plain version at {(b, h, c)}: {err}")
        del rm, rm2
        row = dict(
            ms=cuda_ms(lambda: instance_moments(x)),
            device_ms=device_us(lambda: instance_moments(x), "moments_kernel") / 1e3,
            var_mean_ms=cuda_ms(lambda: torch.var_mean(x, dim=(1, 2), correction=0)),
        )
        us = host_us(lambda: instance_moments(x))
        bms, by = instats_bound(x)
        for k in step:
            step[k] += per_step * row[k]
        print(f"instats B={b} {h}x{h}x{c}: {row['ms']:.4f} ms, {row['device_ms'] * 1e3:.2f} us on the device "
              f"(var_mean {row['var_mean_ms']:.4f}, bound {bms:.4f} by {by}; host {us:.2f} us a call; "
              f"{per_step} a served step); max_abs_err {err:.3e} (tol 1e-5)")
        path = {(SERVE_BATCH, 128, 128): "deid", (VIDEO_T, 256, 64): "video"}.get((b, h, c))
        if path == "video":
            again = instance_moments(x)
            if not (torch.equal(again[0], m) and torch.equal(again[1], m2)):
                raise AssertionError("instats: two calls on the same input differ")
        if path is not None:
            records.append(dict(
                name="instats", route="cuda", source="ppvision_tpu_torch/csrc/instats.cu",
                replaces="ppvision_tpu/ops/instats.py:66", max_abs_err=err, path=path,
                ms=row["ms"], plain_ms=cuda_ms(lambda: _moments_ref(x)),
                bound_ms=bms, bound_by=by, library_ms=row["var_mean_ms"],
                shape=[b, h, h, c], tolerance="max_abs_err <= 1e-5 on both moments",
            ))
    print(f"instats over a served step's {INSTATS_PER_STEP} launches: kernel {step['ms']:.4f} ms, "
          f"{step['device_ms']:.4f} ms on the device, var_mean {step['var_mean_ms']:.4f} ms")
    return records


def conv3x3_bound(x, w) -> tuple[float, str]:
    b, h, wd, c = x.shape
    k = w.shape[-1]
    return bound(2 * (2 * x.numel() + w.numel()), 2 * 9 * b * h * wd * c * k, BF16_FLOP_S)


# (B, H, C, K) of every conv3x3 the two paths launch, with its launches
# per served de-id step at 128^2 (B = 8 sources, R = 10 styles): decode
# runs 8 a style (128^2, 64^2, 32^2, 16^2, 4 x 8^2), encode 8 (64^2,
# 32^2, 16^2, 5 x 8^2), the style encoder 5 at batch R = 10 (64^2 .. 4^2;
# the first four counted at the B = 8 shape of the same H, C, K).  The
# 256^2 generator's new shapes run at the video's batch of 16 and are
# not in the served step.
CONV3X3_SHAPES = {
    (8, 64, 128, 256): 2, (8, 32, 256, 512): 2, (8, 16, 512, 512): 12, (8, 8, 512, 512): 46,
    (8, 128, 128, 128): 10, (8, 64, 256, 256): 10, (8, 32, 512, 512): 10, (10, 4, 512, 512): 1,
    (VIDEO_T, 256, 64, 64): 0, (VIDEO_T, 128, 64, 128): 0, (VIDEO_T, 128, 128, 128): 0,
}
CONV3X3_PER_STEP = sum(CONV3X3_SHAPES.values())  # 93


def check_conv3x3(torch, dev) -> list[dict]:
    """Kernel 4 at all eleven path shapes: error against the plain
    version, the kernel's time in a 20-call window and on the device
    beside ``F.conv2d`` (channels_last) and the bound, one line each, and
    the sums over a served step's 93 launches.  One record at each path's
    largest shape."""
    import torch.nn.functional as F

    from ppvision_tpu_torch.ops.winograd import conv3x3, conv3x3_ref, pack_conv3x3_weight

    g = torch.Generator().manual_seed(3)
    records, step_ms, step_dev_ms, step_lib_ms = [], 0.0, 0.0, 0.0
    for (b, h, c, k), per_step in CONV3X3_SHAPES.items():
        x = torch.randn((b, h, h, c), generator=g).to(dev, torch.bfloat16)
        w = (torch.randn((3, 3, c, k), generator=g) / math.sqrt(9 * c)).to(dev, torch.bfloat16)
        wp = pack_conv3x3_weight(w)  # packed once, as the conv modules cache it
        got = conv3x3(x, wp).float()
        want = conv3x3_ref(x, w).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / (float(want.abs().max()) + 1e-8)
        if not rel < 2e-2:
            raise AssertionError(f"conv3x3 kernel disagrees with F.conv2d at {(b, h, c, k)}: rel {rel}")
        x_cl = x.permute(0, 3, 1, 2)
        w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        ms = cuda_ms(lambda: conv3x3(x, wp))
        dev_ms = device_us(lambda: conv3x3(x, wp), "conv3x3_kernel") / 1e3
        lib_ms = cuda_ms(lambda: F.conv2d(x_cl, w_oihw, padding=1))
        bms, by = conv3x3_bound(x, w)
        step_ms += per_step * ms
        step_dev_ms += per_step * dev_ms
        step_lib_ms += per_step * lib_ms
        print(f"conv3x3 B={b} {h}x{h} {c}->{k}: {ms:.4f} ms, {dev_ms * 1e3:.2f} us on the device (F.conv2d "
              f"{lib_ms:.4f}, bound {bms:.4f} by {by}; {per_step} a served step); max_abs_err {err:.3e} "
              f"rel {rel:.3e} (tol rel 2e-2)")
        path = {(8, 128, 128, 128): "deid", (VIDEO_T, 256, 64, 64): "video"}.get((b, h, c, k))
        if path is not None:
            records.append(dict(
                name="conv3x3", route="cuda", source="ppvision_tpu_torch/csrc/winograd.cu",
                replaces="ppvision_tpu/ops/winograd.py:99", max_abs_err=err, path=path,
                ms=ms, plain_ms=cuda_ms(lambda: conv3x3_ref(x, w)),
                bound_ms=bms, bound_by=by, library_ms=lib_ms,
                shape=[b, h, h, c, k], tolerance="max_abs_err / max|plain| < 2e-2 (bf16 conv error scale)",
            ))
    print(f"conv3x3 over a served step's {CONV3X3_PER_STEP} launches: kernel {step_ms:.4f} ms, "
          f"{step_dev_ms:.4f} ms on the device, F.conv2d {step_lib_ms:.4f} ms")
    return records


def corr_grid_dots(torch, coords, r: int, h2: int, w2: int) -> int:
    """Integer-grid dots this run's coords need: the in-map points of
    each query's (K+1)^2 window (points outside the map cost nothing)."""
    k1 = 2 * r + 2

    def in_map(c, n):
        lo = torch.floor(c.clamp(-(r + 1), n + r)) - r
        return (torch.clamp(lo + k1, 0, n) - torch.clamp(lo, 0, n)).double()

    return int((in_map(coords[..., 0], w2) * in_map(coords[..., 1], h2)).sum())


def corr_bound(torch, f1, f2, coords, r: int) -> tuple[float, str]:
    """fmap1, fmap2, the coords and the output moved once; 2C per in-map
    grid dot and 4 products + 3 sums (+2 weights) per output."""
    b, h, w, c = f1.shape
    k = 2 * r + 1
    nbytes = 4 * (f1.numel() + f2.numel() + coords.numel() + b * h * w * k * k)
    ops = 2 * c * corr_grid_dots(torch, coords, r, *f2.shape[1:3]) + 9 * b * h * w * k * k
    return bound(nbytes, ops, F32_FLOP_S)


def check_corr(torch, dev) -> tuple[dict, list[float]]:
    """Kernel 5 at RAFT's four level shapes of the video path (B=30 pairs,
    32x32 queries, C=256, fmap2 32^2 .. 4^2, radius 4, coords +-6 px
    around the grid), and at B=2, 64x64 queries on a 64x64 map with
    coords over the whole map and r + 2 px past it (a box larger than a
    block's ring).  Each: error against the plain version, coords + 100
    exactly 0, the window ms, the profiler's device us and the bound.
    Two calls agree bit for bit at level 0 and at 64^2.  Returns level
    0's record and the four levels' bounds (ms)."""
    from ppvision_tpu_torch.ops.corr import local_corr, local_corr_ref

    rng = np.random.default_rng(4)
    b, h, c, r = 2 * (VIDEO_T - 1), VIDEO_IMG // 8, 256, RAFT_RADIUS
    f1 = torch.from_numpy(rng.standard_normal((b, h, h, c), dtype=np.float32)).to(dev)
    ys, xs = np.meshgrid(np.arange(h), np.arange(h), indexing="ij")
    grid = np.stack([xs, ys], -1).astype(np.float32)
    cases = []
    for lvl in range(RAFT_LEVELS):
        h2 = h >> lvl
        f2 = torch.from_numpy(rng.standard_normal((b, h2, h2, c), dtype=np.float32)).to(dev)
        # Level coords as RAFT makes them (coords / 2^l) around a flow of
        # +-6 px: negative fractions and windows over every border.
        co = (grid + rng.uniform(-6, 6, (b, h, h, 2)).astype(np.float32)) / 2**lvl
        co[0, 0, 0], co[0, 0, 1], co[0, 1, 0] = (-0.5, -4.75), (h2 - 1, 0.0), (h2 + 3.5, -5.0)
        cases.append((f"level {lvl} B={b} {h}x{h} -> {h2}x{h2}", f1, f2, torch.from_numpy(co).to(dev)))
    n = 64
    spread = (rng.standard_normal((2, n, n, c), dtype=np.float32), rng.standard_normal((2, n, n, c), dtype=np.float32),
              rng.uniform(-(r + 2), n - 1 + r + 2, (2, n, n, 2)).astype(np.float32))
    cases.append((f"whole-map spread B=2 {n}x{n} -> {n}x{n}", *(torch.from_numpy(t).to(dev) for t in spread)))
    bounds, worst = [], 0.0
    for i, (name, f1, f2, coords) in enumerate(cases):
        got = local_corr(f1, f2, coords, r)
        want = local_corr_ref(f1, f2, coords, r)
        far = local_corr(f1, f2, coords + 100.0, r)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        far_max = float(far.abs().max())
        if not err <= tol:
            raise AssertionError(f"corr kernel disagrees with its plain version at {name}: {err} > {tol}")
        if far_max != 0.0:
            raise AssertionError(f"corr kernel gives {far_max} for far-out coords at {name}, not 0")
        if i in (0, RAFT_LEVELS) and not torch.equal(local_corr(f1, f2, coords, r), got):
            raise AssertionError(f"corr kernel: two calls differ at {name}")
        del want, far
        ms = cuda_ms(lambda: local_corr(f1, f2, coords, r))
        dev_us = device_us(lambda: local_corr(f1, f2, coords, r), "corr_band")
        bms, by = corr_bound(torch, f1, f2, coords, r)
        if i < RAFT_LEVELS:
            bounds.append(bms)
        print(f"corr {name} C={c} r={r}: {ms:.4f} ms, {dev_us:.2f} us on the device (bound {bms:.4f} by {by}); "
              f"max_abs_err {err:.3e} (tol {tol:.2e}), coords+100 max {far_max} (must be 0)")
        if i == 0:
            worst, args, level0 = err, (f1, f2, coords), (ms, bms, by)
    f1, f2, coords = args
    ms, bms, by = level0
    record = dict(
        name="corr", route="cuda", source="ppvision_tpu_torch/csrc/corr.cu",
        replaces="ppvision_tpu/ops/corr.py:92", max_abs_err=worst, path="video",
        ms=ms, plain_ms=cuda_ms(lambda: local_corr_ref(f1, f2, coords, r), iters=5, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None,
        shape=[b, h, h, c, r], tolerance="max_abs_err <= 1e-5 * max(1, max|plain|); coords+100 exactly 0",
    )
    print(f"corr: the four levels' bounds sum to {sum(bounds):.4f} ms an iteration")
    return record, bounds


def record_shapes():
    """Wrap the names ``models/stargan.py`` calls instats by and
    ``models/fan.py`` calls denseblock by, so that every call's (B, H, W,
    C, dtype) is counted; returns ({kernel: counts}, undo)."""
    import collections

    from ppvision_tpu_torch.models import fan, stargan

    names = {"instats": (stargan, "instance_moments"), "denseblock": (fan, "fused_dense_block")}
    seen = {k: collections.Counter() for k in names}
    inner = {k: getattr(mod, fn) for k, (mod, fn) in names.items()}

    def spy(kernel):
        def call(x, *args):
            seen[kernel][(*x.shape, str(x.dtype).removeprefix("torch."))] += 1
            return inner[kernel](x, *args)

        return call

    for k, (mod, fn) in names.items():
        setattr(mod, fn, spy(k))

    def undo():
        for k, (mod, fn) in names.items():
            setattr(mod, fn, inner[k])

    return seen, undo


# The shape tables the spies' counts are held to: (B, H, C) -> launches a step.
SHAPE_TABLES = {"instats": INSTATS_SHAPES, "denseblock": DENSEBLOCK_SHAPES}


def unchecked_shapes(seen) -> list:
    """The shapes in ``seen`` that ``check_instats`` and
    ``check_denseblock`` did not check."""
    return [(kernel, k) for kernel, counts in seen.items() for k in counts
            if k[-1] != "bfloat16" or k[1] != k[2] or (k[0], k[1], k[3]) not in SHAPE_TABLES[kernel]]


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


def serve_main_path(torch, kernels, deid_kernels) -> dict:
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
    kernels["instats"].copies = 0
    seen, undo = record_shapes()
    t0 = time.perf_counter()
    outs = list(server.serve(requests))
    wall = time.perf_counter() - t0
    undo()
    launches = {name: fn.launches for name, fn in kernels.items()}
    print(f"served {len(outs)} requests in {wall:.3f} s; launches {launches}; "
          f"instats input copies {kernels['instats'].copies}; stats {server.stats()}")
    if len(outs) != len(requests):
        raise AssertionError(f"{len(outs)} outputs for {len(requests)} requests")
    for o in outs:
        if o.shape != (R_STYLES, IMG, IMG, 3) or not np.isfinite(o).all():
            raise AssertionError(f"bad output: shape {o.shape}, finite {np.isfinite(o).all()}")
    missing = [k for k in deid_kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the de-id path: {missing}")
    steps = -(-len(requests) // SERVE_BATCH)
    if launches["conv3x3"] != steps * CONV3X3_PER_STEP:
        raise AssertionError(f"conv3x3 launched {launches['conv3x3']} times over {steps} served steps, "
                             f"not {CONV3X3_PER_STEP} a step")
    for kernel, table in SHAPE_TABLES.items():
        per_step = sum(table.values())
        if launches[kernel] != steps * per_step:
            raise AssertionError(f"{kernel} launched {launches[kernel]} times over {steps} served steps, "
                                 f"not {per_step} a step")
        want = {(b, h, h, c, "bfloat16"): steps * n for (b, h, c), n in table.items() if n}
        if dict(seen[kernel]) != want:
            raise AssertionError(f"{kernel} shapes of the served run {dict(seen[kernel])} are not {want}")
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
        dense = sum(e.self_device_time_total for e in events if "denseblock" in e.key.lower()) / 1e3
        print(json.dumps({
            "deid_multi_style_img_s": b * R_STYLES / (ms / 1e3), "B": b, "R": R_STYLES,
            "ms_per_call": ms, "device_busy_ms": busy, "device_idle_share": max(0.0, 1 - busy / ms),
            "denseblock_device_ms": dense, "img": IMG, "card": card,
        }))
    print(events.table(sort_by="self_device_time_total", row_limit=15, max_name_column_width=60))


def smooth_frames(n_frames: int, size: int, seed: int) -> np.ndarray:
    """(T, size, size, 3) [0, 1] f32: one seeded smooth image (bicubic
    upsampling of 16x16 noise), rolled 1 px to the right per frame."""
    import torch
    import torch.nn.functional as F

    rng = np.random.default_rng(seed)
    base = torch.from_numpy(rng.random((1, 3, 16, 16), dtype=np.float32))
    img = F.interpolate(base, size=(size, size), mode="bicubic", align_corners=False).clamp(0, 1)
    img = img[0].permute(1, 2, 0).numpy()
    return np.stack([np.roll(img, t, axis=1) for t in range(n_frames)])


def video_path(torch, kernels) -> dict:
    """``cli/main.py::run_video`` on seeded arrays at 256^2: de-id the
    sequence with one fixed reference style, render the interpolation
    video, and score temporal consistency with RAFT on kernel 5."""
    from ppvision_tpu_torch.config import FaceDeIdConfig
    from ppvision_tpu_torch.deid import build_deid, deid_from_reference
    from ppvision_tpu_torch.metrics.temporal import flow_consistency
    from ppvision_tpu_torch.models.raft import build_raft
    from ppvision_tpu_torch.sample import get_alphas, video_ref, write_video

    bundle = build_deid(0, FaceDeIdConfig(), device="cuda")
    raft = build_raft(0, "cuda", corr_levels=RAFT_LEVELS, corr_radius=RAFT_RADIUS, alternate_corr=True)
    srcs = torch.from_numpy(smooth_frames(VIDEO_T, VIDEO_IMG, 21))
    refs = torch.from_numpy(np.random.default_rng(22).random((2, VIDEO_IMG, VIDEO_IMG, 3), dtype=np.float32))
    n = min(8, VIDEO_T)

    def phase():
        fakes = deid_from_reference(
            bundle, srcs, refs[:1].expand(VIDEO_T, -1, -1, -1), torch.zeros(VIDEO_T, dtype=torch.long)
        ).cpu().numpy()
        wrote = write_video(fakes, os.path.join(OUT_DIR, "video_deid.mp4"))
        video = video_ref(bundle, srcs[:n], refs, torch.zeros(2, dtype=torch.long), os.path.join(OUT_DIR, "video_ref.mp4"))
        score = flow_consistency(raft, srcs, fakes, iters=RAFT_ITERS)
        torch.cuda.synchronize()
        return fakes, wrote, video, score

    for fn in kernels.values():
        fn.launches = 0
    kernels["instats"].copies = kernels["corr"].copies = 0
    seen, undo = record_shapes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fakes, wrote, video, score = phase()
    secs = time.perf_counter() - t0
    undo()
    launches = {name: fn.launches for name, fn in kernels.items()}
    print(f"video phase: {secs:.2f} s; flow_consistency_epe {score:.6f}; launches {launches}; "
          f"instats input copies {kernels['instats'].copies}; corr input copies {kernels['corr'].copies}; "
          f"shapes {({k: dict(v) for k, v in seen.items()})}; "
          f"write_video wrote a file: {wrote}; interpolation video {video.shape}")
    unchecked = unchecked_shapes(seen)
    if unchecked:
        raise AssertionError(f"the video phase gave kernel shapes that were not checked: {unchecked}")
    # The same phase again under the profiler: the device's share of it.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        phase()
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events) / 1e3
    instats_ms = sum(e.self_device_time_total for e in events if "moments_kernel" in e.key) / 1e3
    dense_ms = sum(e.self_device_time_total for e in events if "denseblock" in e.key.lower()) / 1e3
    print(f"video phase on the device: {busy:.1f} ms busy, instats {instats_ms:.2f} ms, "
          f"denseblock {dense_ms:.2f} ms")
    if fakes.shape != (VIDEO_T, VIDEO_IMG, VIDEO_IMG, 3) or not np.isfinite(fakes).all():
        raise AssertionError(f"bad de-id sequence: {fakes.shape}, finite {np.isfinite(fakes).all()}")
    want = (len(get_alphas()) + 10, 2 * VIDEO_IMG, VIDEO_IMG + 32 + n * VIDEO_IMG, 3)
    if video.shape != want or not np.isfinite(video).all():
        raise AssertionError(f"bad interpolation video: {video.shape} (want {want}), finite {np.isfinite(video).all()}")
    if not math.isfinite(score):
        raise AssertionError(f"flow_consistency is not finite: {score}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the video path: {missing}")
    if launches["corr"] != RAFT_LEVELS * RAFT_ITERS:
        raise AssertionError(f"corr launched {launches['corr']} times, not {RAFT_LEVELS} levels x {RAFT_ITERS} iters")
    pairs = (torch.cat([srcs[:-1], torch.from_numpy(fakes[:-1])]), torch.cat([srcs[1:], torch.from_numpy(fakes[1:])]))
    return dict(launches=launches, seconds=secs, score=score, pairs=pairs)


def raft_checks(torch, pairs) -> None:
    """The alternate path against the dense path at the same weights on
    the card (B=2, 256^2), and the card against the port's CPU RAFT
    (B=1, 128^2), both at 3 iterations."""
    from ppvision_tpu_torch.models.raft import build_raft

    f1, f2 = (255.0 * p[:2].cuda() for p in pairs)
    alt = build_raft(0, "cuda", corr_levels=RAFT_LEVELS, alternate_corr=True)
    dense = build_raft(0, "cuda", corr_levels=RAFT_LEVELS)
    dense.load_state_dict(alt.state_dict())
    a, d = alt(f1, f2, iters=3), dense(f1, f2, iters=3)
    scale = float(d.abs().max()) + 1e-6
    err = float((a - d).abs().max())
    print(f"RAFT alternate vs dense on the card, B=2 256^2 3 iters: max {err:.3e} (|flow| max {scale:.3f})")
    # The JAX package's own tolerance for this equivalence (tests/test_raft.py).
    if not torch.allclose(a, d, atol=2e-4 * scale, rtol=1e-4):
        raise AssertionError(f"alternate RAFT departs from dense RAFT: {err} (scale {scale})")

    small = [torch.nn.functional.avg_pool2d(255.0 * p[:1].permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1) for p in pairs]
    cpu = build_raft(0, "cpu", corr_levels=RAFT_LEVELS, alternate_corr=True)
    want = cpu(*small, iters=3)
    got = alt(*(t.cuda() for t in small), iters=3).cpu()
    scale = float(want.abs().max()) + 1e-6
    err = float((got - want).abs().max())
    print(f"RAFT card vs CPU, B=1 128^2 3 iters: max {err:.3e} (|flow| max {scale:.3f})")
    # True f32 on both sides (TF32 off); sums in another order through the
    # encoders and 3 refinement steps: the same scale-relative bound.
    if not torch.allclose(got, want, atol=2e-4 * scale, rtol=1e-4):
        raise AssertionError(f"RAFT on the card departs from the CPU: {err} (scale {scale})")


def raft_matmul_conv(torch) -> None:
    """The two motion-encoder convs RAFT runs as unfold + matmul, timed
    both ways at the video path's shape (B=30, 32x32): cuDNN's f32
    heuristics send these two output widths down an FFT-tiled route."""
    import torch.nn.functional as F

    from ppvision_tpu_torch.models.raft import _MatmulConv2d

    b = 2 * (VIDEO_T - 1)
    for cin, cout in ((256, 192), (256, 126)):
        conv = _MatmulConv2d(cin, cout, 3, padding=1).cuda()
        x = torch.randn((b, cin, VIDEO_IMG // 8, VIDEO_IMG // 8), device="cuda")
        print(f"RAFT conv 3x3 {cin}->{cout} B={b} {VIDEO_IMG // 8}^2: unfold+matmul {cuda_ms(lambda: conv(x)):.4f} ms, "
              f"cuDNN {cuda_ms(lambda: F.conv2d(x, conv.weight, conv.bias, padding=1)):.4f} ms")


def raft_throughput(torch, pairs, card: str, video_secs: float, corr_bounds: list[float]) -> None:
    """RAFT pairs/s at the video's batch (B=30, 256^2, 12 iterations) on
    the alternate (kernel 5) and the dense path, and the device's busy
    share of one profiled call; on the alternate path, the corr kernel's
    device ms and launches in that call beside 12 x the four levels'
    bounds."""
    from ppvision_tpu_torch.models.raft import build_raft

    f1, f2 = (255.0 * p.cuda() for p in pairs)
    b = f1.shape[0]
    for alt in (True, False):
        raft = build_raft(0, "cuda", corr_levels=RAFT_LEVELS, alternate_corr=alt)
        ms = cuda_ms(lambda: raft(f1, f2, iters=RAFT_ITERS), iters=3, warmup=1)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            raft(f1, f2, iters=RAFT_ITERS)
            torch.cuda.synchronize()
        events = prof.key_averages()
        busy = sum(e.self_device_time_total for e in events) / 1e3
        corr = [e for e in events if "corr_band" in e.key]
        line = {
            "raft_pairs_s": b / (ms / 1e3), "alternate_corr": alt, "B": b, "img": VIDEO_IMG,
            "iters": RAFT_ITERS, "ms_per_call": ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1 - busy / ms), "video_phase_s": video_secs, "card": card,
        }
        if alt:
            line.update(corr_device_ms=sum(e.self_device_time_total for e in corr) / 1e3,
                        corr_launches=sum(e.count for e in corr),
                        corr_bound_ms=RAFT_ITERS * sum(corr_bounds))
            if line["corr_launches"] != RAFT_LEVELS * RAFT_ITERS:
                print(f"corr: the profiler saw {line['corr_launches']} launches, not {RAFT_LEVELS * RAFT_ITERS}")
        print(json.dumps(line))
        print(events.table(sort_by="self_device_time_total", row_limit=12, max_name_column_width=60))


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)

    import torch

    from ppvision_tpu_torch.ops import DEID_KERNELS, KERNELS, _build

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
        report = _build.ptxas_report(name)
        print(report, end="")
        if "C7513" in report or "C7515" in report:
            raise AssertionError(f"ptxas serialized the wgmmas of csrc/{name}.cu")

    corr_record, corr_bounds = check_corr(torch, dev)
    records = [*check_fftconv(torch, dev), check_denseblock(torch, dev),
               *check_instats(torch, dev), *check_conv3x3(torch, dev), corr_record]
    for r in records:
        print(f"{r['name']} {r['shape']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
              f"bound {r['bound_ms']:.4f} by {r['bound_by']}, library {r['library_ms']})")
    launches = serve_main_path(torch, KERNELS, DEID_KERNELS)
    gpu_vs_cpu(torch)
    throughput(torch, card)
    video = video_path(torch, KERNELS)
    raft_checks(torch, video["pairs"])
    raft_matmul_conv(torch)
    raft_throughput(torch, video["pairs"], card, video["seconds"], corr_bounds)

    # A record at a de-id shape takes its launches from the served run; at
    # a video shape (fftconv at 256^2, corr), from the video path.
    for r in records:
        r["launches"] = (launches if r["path"] == "deid" else video["launches"])[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "shape")
    print(card)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
