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
   levels' bounds, and the video phase's seconds;
10. the conv3x3 and instats autograd Functions' gradients at every train
   shape against the plain versions' autograd, R1's second order through
   a kernel conv included;
11. the train phase at the reference recipe (``FaceDeIdConfig()``:
   256x256, full width, bf16, B = 4, LPIPS, RAFT flow at 20 iterations):
   3 steps on seeded batches, each step's losses, seconds and launches
   (the counts set to 0 before each step), checks that every loss is
   finite, every net moved and each EMA less than its net, that conv3x3,
   instats, fftconv and denseblock launched in every step, and that no
   conv3x3, instats or denseblock shape went unchecked; one more step
   under ``torch.profiler`` for the device's busy share and a breakdown;
12. one 64x64 train step on the card against the port's CPU path, in f32
   and in bf16;
13. the int8 decode's products (``ops/quant.py``, ``torch._int_mm``) at
   every quantized decode shape: int32 accumulators bit for bit against
   the f64 plain version, outputs bit for bit against the CPU path, and
   their times beside the exact path's convs and the int8 bound;
14. the int8 served run (``quant_decode=True``, 128x128 full width,
   batch 8, R = 10): launch counts (conv3x3 13 a step), the int8 output
   within (1e-5, 0.25) of the exact one, its quality gates against the
   exact one (SSIM > 0.9, face-ID cosine >= 0.98; ``int8_gates``), and
   the img/s of both, labelled;
15. ``remat``: one ``FaceDeIdConfig()`` step with and without it, losses
   bit for bit, gradients at cosine >= 0.9999, the peak device memory
   and seconds of each;
16. the CLI (``cli/main.py``) at ``FaceDeIdConfig()`` full width: 2
   training iterations from folders of seeded arrays, a resumed third,
   and ``--mode sample`` from the checkpoint;
17. the evaluation (``metrics/eval_gan.py``) at ``FaceDeIdConfig()``
   full width with full-size random metric nets (InceptionV3, IResNet-50,
   AlexNet), 2 domains x 16 images, batch 8, 10 outputs a source: latent
   mode, reference mode and latent mode with the aligned face-ID embed,
   launch counts set to 0 just before each and read just after, no
   conv3x3, instats or denseblock shape that step 3 did not check; the
   multi-output fakes against a per-style ``deid_from_latent`` loop, bit
   for bit (``eval_phase``).  Its FIDs (a host ``sqrtm`` each) run in
   worker processes during step 18; then every value is checked and each
   run's seconds print split into generation, LPIPS, face-ID, Inception
   and the FIDs;
18. ROADMAP.md section 3's study of the bf16 ``G/ref_ds`` gap: at step
   12's 64x64 step and five seeds, G/ref's fakes with the four kernels,
   their plain versions, and the kernels with one plain version at a
   time, against f32 (``ref_ds_study``);
19. the evaluation at a 64^2 f32 configuration on the card against the
   port's CPU path, and the three metric nets at full size card against
   CPU in f32;
20. the face aligner (``models/align.py``, ``--mode align``'s) on 8
   seeded 256^2 faces, card against CPU, with its ms an image split into
   the FAN, the mirror-pad and blur, and the LANCZOS4 warp;
21. the captioning path (``caption_phase``) at full width: which of h5py,
   nltk, cv2 and PIL import (the lens's mask rule follows cv2);
   ``make_caption_train_step`` for 3 steps at ``CaptionConfig()`` (widths
   512, 36x36 features) with ``cli/caption.py::_setup``'s ``LensSpec()``
   (896^2 wave grid, 350 terms) and bf16 ResNet-101, B = 64, 52-token
   captions, a 9,490-entry word map: s/step, peak GiB, the losses finite,
   the stem fixed, the BN statistics moved; the same with ``remat``;
   ``evaluate_captions`` on 32 in-memory 256^2 images (batch 16, beam 5,
   50 steps) split into camera, encoder, beam search, image metrics and
   text metrics, with captions/s, PSNR and SSIM; one small-width f32 step
   and a beam search card against CPU; ``cli/caption.py train`` (1 epoch
   of 2 steps at B = 4) and ``eval``.  Where h5py or nltk does not
   import, only that host piece is swapped (in-memory splits for
   ``CaptionDataset``; NaN stand-ins for BLEU, METEOR and ROUGE-Lsum), and
   the phase says so.  No port kernel may launch in it.

Each phase's seconds print as it ends, and all of them on one JSON line
with the build's and the total.  The last four lines of standard output
are the int8 products' JSON record, the card's name and power limit, the kernels' JSON record and
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
TRAIN_B = 4  # TrainConfig().batch_size: the reference recipe's batch
TRAIN_STEPS = 3
EVAL_B = 8  # TrainConfig().val_batch_size
EVAL_R = 10  # TrainConfig().num_outs_per_domain
EVAL_RB = EVAL_R * EVAL_B  # the eval's style-encoder and aligned-FAN batch: every output of a source batch


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
    """Kernel 1 at the paths' shapes: the de-id camera (B=8, 128^2), the
    video camera (B=16, 256^2), the train camera (B=4, 256^2) and the
    eval camera (B=8, 256^2); one record each."""
    from ppvision_tpu_torch.ops.fftconv import fftconv_circular, fftconv_circular_ref
    from ppvision_tpu_torch.optics.camera import Camera, CameraSpec, compute_psf, make_camera_constants

    records = []
    for n, b, path in ((IMG, SERVE_BATCH, "deid"), (VIDEO_IMG, VIDEO_T, "video"), (VIDEO_IMG, TRAIN_B, "train"),
                       (VIDEO_IMG, EVAL_B, "eval")):
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
# served shapes), and the train phase three FANs a step at its batch of 4;
# the eval's aligned face-ID embed runs the bundle's FAN on a source
# batch's 80 outputs at once; none of that is in the served step.  The
# served run and the video, train and eval phases check that they take
# no other shape.
DENSEBLOCK_SHAPES = {
    (8, 64, 128): 1, (8, 64, 256): 2, (8, 32, 256): 3, (8, 16, 256): 3, (8, 8, 256): 3, (8, 4, 256): 3,
    (VIDEO_T, 64, 128): 0, (VIDEO_T, 64, 256): 0, (VIDEO_T, 32, 256): 0, (VIDEO_T, 16, 256): 0,
    (VIDEO_T, 8, 256): 0, (VIDEO_T, 4, 256): 0,
    (TRAIN_B, 64, 128): 0, (TRAIN_B, 64, 256): 0, (TRAIN_B, 32, 256): 0, (TRAIN_B, 16, 256): 0,
    (TRAIN_B, 8, 256): 0, (TRAIN_B, 4, 256): 0,
    (EVAL_RB, 64, 128): 0, (EVAL_RB, 64, 256): 0, (EVAL_RB, 32, 256): 0, (EVAL_RB, 16, 256): 0,
    (EVAL_RB, 8, 256): 0, (EVAL_RB, 4, 256): 0,
}
DENSEBLOCK_PER_STEP = sum(DENSEBLOCK_SHAPES.values())  # 15


def fan_args(ks, bns) -> tuple:
    """The kernel's arguments after x as ``DenseConvBlock`` hands them
    over: the weights packed, the BN pairs in one (6, F) pack."""
    from ppvision_tpu_torch.ops.denseblock import pack_dense_bn
    from ppvision_tpu_torch.ops.winograd import pack_conv3x3_weight

    return (*[pack_conv3x3_weight(k) for k in ks], pack_dense_bn(bns, ks[0].shape[2]))


def check_denseblock(torch, dev, kernel_args=fan_args) -> list[dict]:
    """Kernel 2 at every shape of ``DENSEBLOCK_SHAPES``, called with
    ``kernel_args(ks, bns)`` after x: error against the plain version
    (the cuDNN chain), the kernel's time in a 20-call window and on the
    device (its passes summed) beside the chain's and the bound, one line
    each, and the sums over a served step's 15 launches.  At 8x64x64x256
    two calls and the HWIO call must agree bit for bit; one record there
    and one at the train phase's 4x64x64x256."""
    from ppvision_tpu_torch.ops.denseblock import dense_block_ref, fused_dense_block

    g = torch.Generator(device=dev).manual_seed(1)
    records, step = [], {"ms": 0.0, "device_ms": 0.0, "chain_ms": 0.0}
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
        path = {(SERVE_BATCH, 64, 256): "deid", (TRAIN_B, 64, 256): "train"}.get((b, h, f))
        if path is not None:
            records.append(dict(
                name="denseblock", route="cuda", source="ppvision_tpu_torch/csrc/denseblock.cu",
                replaces="ppvision_tpu/ops/denseblock.py:124", max_abs_err=err, path=path,
                ms=row["ms"], plain_ms=row["chain_ms"], bound_ms=bms, bound_by=by, library_ms=None,
                shape=[b, h, h, f], tolerance="max_abs_err / max|plain| < 2e-2 (bf16 conv error scale)",
            ))
    print(f"denseblock over a served step's {DENSEBLOCK_PER_STEP} launches: kernel {step['ms']:.4f} ms, "
          f"{step['device_ms']:.4f} ms on the device, cuDNN chain {step['chain_ms']:.4f} ms")
    return records


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
# them under 31 styles at once (B = 248); the train phase runs it at its
# batch of 4, forward and backward; the eval runs it at its source batch
# of 8 (the shapes of the (8, 256, 64) row and the served rows); none of
# that is in the served step.  The served run and the video, train and
# eval phases check that they take no other shape.
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
    (TRAIN_B, 256, 64): 0, (TRAIN_B, 128, 64): 0, (TRAIN_B, 128, 128): 0, (TRAIN_B, 64, 128): 0,
    (TRAIN_B, 64, 256): 0, (TRAIN_B, 32, 256): 0, (TRAIN_B, 32, 512): 0, (TRAIN_B, 16, 512): 0,
    (TRAIN_B, 8, 512): 0,
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
        path = {(SERVE_BATCH, 128, 128): "deid", (VIDEO_T, 256, 64): "video", (TRAIN_B, 256, 64): "train"}.get((b, h, c))
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
# not in the served step.  The train phase runs the 256^2 generator, the
# style encoder and the discriminator at its batch of 4, and checks that
# it gives no other shape.  The eval runs the 256^2 generator at its
# source batch of 8 and, in reference mode, the style encoder on a
# source batch's 80 reference faces at once; it checks likewise.
CONV3X3_SHAPES = {
    (8, 64, 128, 256): 2, (8, 32, 256, 512): 2, (8, 16, 512, 512): 12, (8, 8, 512, 512): 46,
    (8, 128, 128, 128): 10, (8, 64, 256, 256): 10, (8, 32, 512, 512): 10, (10, 4, 512, 512): 1,
    (VIDEO_T, 256, 64, 64): 0, (VIDEO_T, 128, 64, 128): 0, (VIDEO_T, 128, 128, 128): 0,
    (TRAIN_B, 256, 64, 64): 0, (TRAIN_B, 128, 64, 128): 0, (TRAIN_B, 128, 128, 128): 0,
    (TRAIN_B, 64, 128, 256): 0, (TRAIN_B, 64, 256, 256): 0, (TRAIN_B, 32, 256, 512): 0,
    (TRAIN_B, 32, 512, 512): 0, (TRAIN_B, 16, 512, 512): 0, (TRAIN_B, 8, 512, 512): 0,
    (TRAIN_B, 4, 512, 512): 0,
    (EVAL_B, 256, 64, 64): 0, (EVAL_B, 128, 64, 128): 0,
    (EVAL_RB, 128, 64, 128): 0, (EVAL_RB, 64, 128, 256): 0, (EVAL_RB, 32, 256, 512): 0,
    (EVAL_RB, 16, 512, 512): 0, (EVAL_RB, 8, 512, 512): 0, (EVAL_RB, 4, 512, 512): 0,
}
CONV3X3_PER_STEP = sum(CONV3X3_SHAPES.values())  # 93
# With quant_decode the decoder's 8 convs a style run in int8: the
# encoder's 8 and the style encoder's 5 stay.
CONV3X3_INT8_PER_STEP = CONV3X3_PER_STEP - 8 * R_STYLES  # 13


def check_conv3x3(torch, dev) -> list[dict]:
    """Kernel 4 at every shape of ``CONV3X3_SHAPES``: error against the plain
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
        path = {(8, 128, 128, 128): "deid", (VIDEO_T, 256, 64, 64): "video",
                (TRAIN_B, 256, 64, 64): "train"}.get((b, h, c, k))
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
    """Wrap the names ``models/stargan.py`` calls instats and conv3x3 by
    and ``models/fan.py`` calls denseblock by, so that every call's (B, H,
    W, C, dtype) is counted (conv3x3's with its K before the dtype);
    returns ({kernel: counts}, undo)."""
    import collections

    from ppvision_tpu_torch.models import fan, stargan

    names = {"instats": (stargan, "instance_moments"), "denseblock": (fan, "fused_dense_block"),
             "conv3x3": (stargan, "conv3x3")}
    seen = {k: collections.Counter() for k in names}
    inner = {k: getattr(mod, fn) for k, (mod, fn) in names.items()}

    def spy(kernel):
        def call(x, *args):
            shape = tuple(x.shape)
            if kernel == "conv3x3":
                w = args[-1] if args[-1] is not None else args[0]
                shape += (w.shape[2] if w.ndim == 5 else w.shape[-1],)
            seen[kernel][(*shape, str(x.dtype).removeprefix("torch."))] += 1
            return inner[kernel](x, *args)

        return call

    for k, (mod, fn) in names.items():
        setattr(mod, fn, spy(k))

    def undo():
        for k, (mod, fn) in names.items():
            setattr(mod, fn, inner[k])

    return seen, undo


# The shape tables the spies' counts are held to: (B, H, C[, K]) -> launches a step.
SHAPE_TABLES = {"instats": INSTATS_SHAPES, "denseblock": DENSEBLOCK_SHAPES, "conv3x3": CONV3X3_SHAPES}


def unchecked_shapes(seen, kernels=("instats", "denseblock")) -> list:
    """The shapes in ``seen`` of ``kernels`` that their checks
    (``check_instats``, ``check_denseblock``, ``check_conv3x3``) did not
    check."""
    return [(kernel, k) for kernel in kernels for k in seen[kernel]
            if k[-1] != "bfloat16" or k[1] != k[2] or (k[0], k[1], *k[3:-1]) not in SHAPE_TABLES[kernel]]


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
    for kernel in ("instats", "denseblock"):
        table = SHAPE_TABLES[kernel]
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
    """``cli/main.py::run_video``'s array part (``video_from_arrays``) on
    seeded arrays at 256^2: de-id the sequence with one fixed reference
    style, render the interpolation video on 8 sources, and score
    temporal consistency with RAFT on kernel 5."""
    from ppvision_tpu_torch.cli.main import video_from_arrays
    from ppvision_tpu_torch.config import FaceDeIdConfig
    from ppvision_tpu_torch.deid import build_deid
    from ppvision_tpu_torch.models.raft import build_raft
    from ppvision_tpu_torch.sample import get_alphas

    bundle = build_deid(0, FaceDeIdConfig(), device="cuda")
    raft = build_raft(0, "cuda", corr_levels=RAFT_LEVELS, corr_radius=RAFT_RADIUS, alternate_corr=True)
    srcs = torch.from_numpy(smooth_frames(VIDEO_T, VIDEO_IMG, 21))
    refs = torch.from_numpy(np.random.default_rng(22).random((2, VIDEO_IMG, VIDEO_IMG, 3), dtype=np.float32))
    n = min(8, VIDEO_T)

    def phase():
        out = video_from_arrays(bundle, srcs, refs, OUT_DIR, raft, n_interp=n)
        torch.cuda.synchronize()
        return out["fakes"], out["wrote"], out["video"], out["score"]

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


def _rel(got, want) -> float:
    """max |got - want| over max |want| (the bf16 kernels' error scale)."""
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max()) / (float(want.abs().max()) + 1e-12)


def check_train_grads(torch, dev) -> None:
    """The conv3x3 and instats Functions' gradients at every train shape
    against the plain versions' autograd on the same inputs: dx and dw of
    sum(g * conv(x, w)), and R1's second order through a kernel conv,
    d/dw of |d/dx sum(g * leaky_relu(conv(x, w)))|^2 (there the sign
    pattern comes from each side's own forward).  Each within 2e-2 of
    its output scale; each kernel output must carry a grad_fn."""
    import torch.nn.functional as F

    from ppvision_tpu_torch.ops.instats import _moments_ref, instance_moments
    from ppvision_tpu_torch.ops.winograd import conv3x3, conv3x3_ref, pack_conv3x3_weight

    g = torch.Generator(device=dev).manual_seed(5)
    worst = {"conv3x3 dx": 0.0, "conv3x3 dw": 0.0, "conv3x3 R1 dw": 0.0, "instats dx": 0.0}
    with torch.enable_grad():
        for b, h, c, k in (s for s in CONV3X3_SHAPES if s[0] == TRAIN_B):
            x = torch.randn((b, h, h, c), generator=g, device=dev, dtype=torch.bfloat16).requires_grad_(True)
            w = (torch.randn((3, 3, c, k), generator=g, device=dev) / math.sqrt(9 * c)).to(torch.bfloat16)
            w.requires_grad_(True)
            cot = torch.randn((b, h, h, k), generator=g, device=dev)
            packed = pack_conv3x3_weight(w.detach())
            grads = {}
            for name, fn in (("kernel", lambda x, w: conv3x3(x, w, packed)), ("plain", conv3x3_ref)):
                y = fn(x, w)
                if name == "kernel" and y.grad_fn is None:
                    raise AssertionError("conv3x3's output carries no grad_fn")
                dx, dw = torch.autograd.grad((y.float() * cot).sum(), (x, w), retain_graph=True)
                (dx2,) = torch.autograd.grad((F.leaky_relu(y.float(), 0.2) * cot).sum(), x, create_graph=True)
                (r1,) = torch.autograd.grad(dx2.float().square().sum(), w)
                grads[name] = (dx, dw, r1)
            for key, a, want in zip(("conv3x3 dx", "conv3x3 dw", "conv3x3 R1 dw"), grads["kernel"], grads["plain"]):
                worst[key] = max(worst[key], _rel(a, want))
        for b, h, c in (s for s in INSTATS_SHAPES if s[0] == TRAIN_B):
            x = torch.randn((b, h, h, c), generator=g, device=dev, dtype=torch.bfloat16).requires_grad_(True)
            gm, gm2 = torch.randn((2, b, c), generator=g, device=dev)
            m, m2 = instance_moments(x)
            if m.grad_fn is None or m2.grad_fn is None:
                raise AssertionError("instats' outputs carry no grad_fn")
            (got,) = torch.autograd.grad((m * gm).sum() + (m2 * gm2).sum(), x)
            rm, rm2 = _moments_ref(x)
            (want,) = torch.autograd.grad((rm * gm).sum() + (rm2 * gm2).sum(), x)
            worst["instats dx"] = max(worst["instats dx"], _rel(got, want))
    print(f"train grads at the {sum(s[0] == TRAIN_B for s in CONV3X3_SHAPES)} conv3x3 and "
          f"{sum(s[0] == TRAIN_B for s in INSTATS_SHAPES)} instats train shapes, kernel against plain "
          f"(worst rel of the output scale, tol 2e-2): {worst}")
    bad = {k: v for k, v in worst.items() if not v < 2e-2}
    if bad:
        raise AssertionError(f"kernel Function gradients depart from the plain versions': {bad}")


def train_batches(cfg, n: int, batch: int, seed: int = 31) -> list[dict]:
    """``n`` NHWC [0, 1] batches from a numpy seed, z from a torch.Generator."""
    import torch

    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    size = cfg.model.img_size
    out = []
    for _ in range(n):
        out.append(dict(
            x_src=rng.random((batch, size, size, 3), dtype=np.float32),
            x_ref=rng.random((batch, size, size, 3), dtype=np.float32),
            x_ref2=rng.random((batch, size, size, 3), dtype=np.float32),
            y_src=rng.integers(0, cfg.model.num_domains, batch), y_ref=rng.integers(0, cfg.model.num_domains, batch),
            z_trg=torch.randn((batch, cfg.model.latent_dim), generator=g),
            z_trg2=torch.randn((batch, cfg.model.latent_dim), generator=g),
        ))
    return out


def build_trainer(cfg, device: str, grad_hook=None, seed: int = 0):
    from ppvision_tpu_torch.train.gan import init_gan, make_train_step
    from ppvision_tpu_torch.train.pretrained import build_aux_losses, load_frozen_nets

    state = init_gan(seed, cfg, device)
    frozen = load_frozen_nets(cfg, seed, device)
    lpips_fn, flow_fn = build_aux_losses(cfg, seed, device)
    return state, frozen, make_train_step(cfg, lpips_fn, flow_fn, grad_hook=grad_hook)


def _max_delta(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def train_path(torch, kernels, card: str) -> dict:
    """``train/gan.py`` at the reference recipe (``FaceDeIdConfig()``:
    256^2, full width, bf16, batch 4, LPIPS x2000, RAFT flow x10 at 20
    iterations): 3 steps on seeded batches, the counts set to 0 before
    each step and read after it.  Every loss finite, every net moved,
    each EMA less than its net; conv3x3, instats, fftconv and denseblock
    launched in every step; no conv3x3, instats or denseblock shape that
    their checks did not check.  Then one more step under
    ``torch.profiler``: the device's busy share of a step."""
    from ppvision_tpu_torch.config import FaceDeIdConfig

    cfg = FaceDeIdConfig()
    state, frozen, step = build_trainer(cfg, "cuda")
    batches = train_batches(cfg, TRAIN_STEPS + 1, TRAIN_B)
    before = {k: [p.detach().clone() for p in m.parameters()] for k, m in state.nets.items()}
    ema_before = {k: [p.detach().clone() for p in m.parameters()] for k, m in state.ema.items()}
    totals = {name: 0 for name in kernels}
    seconds = []
    seen, undo = record_shapes()
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_STEPS):
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(state, frozen, batches[i])
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches = {name: fn.launches for name, fn in kernels.items()}
        for name in totals:
            totals[name] += launches[name]
        losses = {k: float(v) for k, v in metrics.items()}
        print(f"train step {i}: {seconds[-1]:.3f} s; launches {launches}; losses {json.dumps(losses)}")
        bad = [k for k, v in losses.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"train step {i}: losses not finite: {bad}")
        missing = [k for k in ("conv3x3", "instats", "fftconv", "denseblock") if launches[k] == 0]
        if missing:
            raise AssertionError(f"train step {i}: kernels not launched: {missing}")
    undo()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"train shapes {({k: dict(v) for k, v in seen.items()})}; instats input copies "
          f"{kernels['instats'].copies}; peak device memory {peak_gib:.2f} GiB")
    unchecked = unchecked_shapes(seen, ("conv3x3", "instats", "denseblock"))
    if unchecked:
        raise AssertionError(f"the train phase gave kernel shapes that were not checked: {unchecked}")
    for name, params in before.items():
        moved = _max_delta(state.nets[name].parameters(), params)
        if not moved > 0:
            raise AssertionError(f"train: {name} did not move")
        if name in ema_before:
            ema_moved = _max_delta(state.ema[name].parameters(), ema_before[name])
            print(f"train: {name} moved {moved:.3e}, its EMA {ema_moved:.3e}")
            if not 0 < ema_moved < moved:
                raise AssertionError(f"train: the EMA of {name} moved {ema_moved}, its net {moved}")
    # One more step under the profiler: the device's share of a step.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, frozen, batches[TRAIN_STEPS])
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events) / 1e3
    # conv3x3_kernel<..., DenseBlockEpi> is a denseblock pass; fftconv is
    # rows_forward, columns and rows_inverse.
    names = {
        "conv3x3": lambda k: "conv3x3_kernel" in k and "denseblock" not in k,
        "instats": lambda k: "moments_kernel" in k,
        "denseblock": lambda k: "denseblock" in k,
        "fftconv": lambda k: any(n in k for n in ("rows_forward", "void columns", "rows_inverse")),
    }
    by_kernel = {name: sum(e.self_device_time_total for e in events if f(e.key.lower())) / 1e3
                 for name, f in names.items()}
    kinds = {
        "port_kernels": lambda k: any(f(k) for f in names.values()),
        "cudnn_and_gemm": lambda k: any(n in k for n in ("xmma", "conv", "dgrad", "wgrad", "gemm", "cutlass")),
        "elementwise": lambda k: "elementwise" in k,
        "reduce": lambda k: "reduce" in k,
    }
    by_kind = {}
    for e in events:
        key = e.key.lower()
        kind = next((n for n, f in kinds.items() if f(key)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + e.self_device_time_total / 1e3
    steady = min(seconds[1:])
    line = {
        "train_step_s": seconds, "steady_step_s": steady, "B": TRAIN_B, "img": cfg.model.img_size,
        "flow_iters": cfg.train.flow_iters, "profiled_step_s": profiled_s, "device_busy_ms": busy,
        "device_idle_share_of_steady_step": max(0.0, 1 - busy / (steady * 1e3)),
        "device_idle_share_profiled": max(0.0, 1 - busy / (profiled_s * 1e3)), "kernel_device_ms": by_kernel,
        "device_ms_by_kind": by_kind, "peak_gib": peak_gib, "card": card,
    }
    print(json.dumps(line))
    print(events.table(sort_by="self_device_time_total", row_limit=15, max_name_column_width=60))
    return dict(launches=totals, seconds=seconds)


def plain_kernels(only=None):
    """Point the names the modules call the four de-id kernels by at
    their plain versions (only the kernel named ``only``, where given);
    returns undo."""
    from ppvision_tpu_torch.models import fan, stargan
    from ppvision_tpu_torch.ops import denseblock, fftconv, instats, winograd
    from ppvision_tpu_torch.optics import fourier

    def conv(x, w, packed=None):
        return winograd.conv3x3_ref(x, w if w is not None else winograd.unpack_conv3x3_weight(packed, x.shape[-1]))

    def dense(x, k1, k2, k3, *bn):
        return denseblock._plain(x, k1, k2, k3, *denseblock._flat_bn(bn))

    names = {"conv3x3": (stargan, "conv3x3", conv), "instats": (stargan, "instance_moments", instats._moments_ref),
             "denseblock": (fan, "fused_dense_block", dense),
             "fftconv": (fourier, "fftconv_circular", fftconv.fftconv_circular_ref)}
    chosen = [names[only]] if only is not None else list(names.values())
    inner = [(mod, name, getattr(mod, name)) for mod, name, _ in chosen]
    for mod, name, fn in chosen:
        setattr(mod, name, fn)

    def undo():
        for mod, name, fn in inner:
            setattr(mod, name, fn)

    return undo


def small_train_cfg(dtype: str):
    """The 64^2 train configuration of ``train_gpu_vs_cpu``: max_conv_dim
    64, FAN at 64, camera n = 64, RAFT at 3 iterations."""
    from ppvision_tpu_torch.config import CameraConfig, FaceDeIdConfig, ModelConfig, TrainConfig

    return FaceDeIdConfig(
        model=ModelConfig(img_size=64, max_conv_dim=64, fan_input_size=64, compute_dtype=dtype),
        camera=CameraConfig(n=64), train=TrainConfig(flow_iters=3),
    )


def train_gpu_vs_cpu(torch, kernels) -> None:
    """One train step at a reduced width (64^2, max_conv_dim 64, FAN at
    64, RAFT at 3 iterations; B = 2) on the card and on the port's CPU
    path, same seeded weights and batch.  Every run applies the CPU bf16
    run's gradients in place of its own, so each sub-step starts from the
    same weights everywhere: Adam's first step moves every weight by
    +-lr whatever the size of its gradient, so a rounding that flips a
    near-zero gradient's sign would move that weight by 2 lr and later
    sub-steps would compare other weights.

    f32 (instats and fftconv on the card; TF32 off): every loss within
    2e-2 relative of the CPU's, each sub-step's gradient of each net at
    cosine >= 0.98.  bf16 (the four de-id kernels): each loss and
    gradient no further from the CPU's f32 run than 1.5 x the farther of
    two other bf16 runs (the CPU's, and the card's with the plain
    versions in place of the kernels), nor than 1.5 x the f32 bounds.
    With random weights the generator's L1 terms take the sign of small
    differences, so in bf16 its gradient is mostly rounding noise, and
    ``G/ref_ds`` (the mean of a difference of two fakes) moves between
    bf16 runs by more than the f32 bound."""
    cfg = small_train_cfg
    batch = train_batches(cfg("float32"), 1, 2, seed=37)[0]
    runs, teacher = {}, {}
    for name, dtype, dev in (("cpu16", "bfloat16", "cpu"), ("card16", "bfloat16", "cuda"),
                             ("card16_plain", "bfloat16", "cuda"), ("cpu32", "float32", "cpu"),
                             ("card32", "float32", "cuda")):
        grads = {}

        def hook(sub, by_net):
            for net, gs in by_net.items():
                grads[sub, net] = torch.cat([g.detach().double().flatten().cpu() for g in gs])
            if sub not in teacher:
                teacher[sub] = {net: [g.detach().cpu().clone() for g in gs] for net, gs in by_net.items()}
                return None
            return {net: [g.to(gs[0].device) for g in teacher[sub][net]] for net, gs in by_net.items()}

        undo = plain_kernels() if name.endswith("_plain") else (lambda: None)
        for fn in kernels.values():
            fn.launches = 0
        state, frozen, step = build_trainer(cfg(dtype), dev, grad_hook=hook)
        t0 = time.perf_counter()
        losses = {k: float(v) for k, v in step(state, frozen, batch).items()}
        undo()
        launched = {k: fn.launches for k, fn in kernels.items()}
        print(f"train step at 64^2, {name}: {time.perf_counter() - t0:.2f} s; launches {launched}")
        if name == "card16" and not all(launched[k] for k in ("conv3x3", "instats", "fftconv", "denseblock")):
            raise AssertionError(f"the bf16 card step did not launch every de-id kernel: {launched}")
        if name == "card16_plain" and any(launched.values()):
            raise AssertionError(f"the plain bf16 card step launched kernels: {launched}")
        runs[name] = losses, grads

    def rel(a, b):
        return {k: abs(runs[a][0][k] - runs[b][0][k]) / max(abs(runs[b][0][k]), 1e-6) for k in runs[b][0]}

    def angle(a, b):  # 1 - cosine
        ga, gb = runs[a][1], runs[b][1]
        return {f"{s}:{n}": 1 - float(ga[s, n] @ gb[s, n] / (ga[s, n].norm() * gb[s, n].norm() + 1e-30))
                for s, n in gb}

    r32, a32 = rel("card32", "cpu32"), angle("card32", "cpu32")
    r16, a16 = rel("card16", "cpu32"), angle("card16", "cpu32")
    noise = {k: max(rel("cpu16", "cpu32")[k], rel("card16_plain", "cpu32")[k], 2e-2) for k in r16}
    anoise = {k: max(angle("cpu16", "cpu32")[k], angle("card16_plain", "cpu32")[k], 2e-2) for k in a16}
    for tag, r, a in (("f32 card vs CPU", r32, a32), ("bf16 card vs CPU f32", r16, a16),
                      ("bf16 CPU vs CPU f32", rel("cpu16", "cpu32"), angle("cpu16", "cpu32")),
                      ("bf16 card plain vs CPU f32", rel("card16_plain", "cpu32"), angle("card16_plain", "cpu32"))):
        print(f"train {tag}: loss rel {json.dumps(r)}; gradient 1 - cosine {json.dumps(a)}")
    bad = [f"f32 {k}" for k, v in r32.items() if not v <= 2e-2] + [f"f32 {k}" for k, v in a32.items() if not v <= 2e-2]
    bad += [f"bf16 {k}" for k, v in r16.items() if not v <= 1.5 * noise[k]]
    bad += [f"bf16 {k}" for k, v in a16.items() if not v <= 1.5 * anoise[k]]
    if bad:
        raise AssertionError(f"the train step on the card departs from the CPU's: {bad}")


STUDY_SEEDS = (0, 1, 2, 3, 4)
STUDY_RUNS = ("plain", "f32", "kernels", "plain:conv3x3", "plain:instats", "plain:denseblock", "plain:fftconv")
BF16_RUNS = tuple(r for r in STUDY_RUNS if r != "f32")


def ref_ds_study(torch, kernels, device: str = "cuda") -> dict:
    """ROADMAP.md section 3's open item: is the bf16 train step's
    ``G/ref_ds`` on the card, 2.4e-2 from f32 with the kernels against
    4.1e-3 with their plain versions (``train_gpu_vs_cpu``), a fault or
    rounding?  At ``train_gpu_vs_cpu``'s configuration and batch size
    (64^2, B = 2), for each seed (weights and batch): one step on the card
    in f32 (the reference), in bf16 with the plain versions (the teacher:
    every run applies its gradients, so the G/ref sub-step starts from the
    same weights in all), with the four kernels, and with the kernels but
    one plain version ("plain:NAME": NAME's plain version, the other
    three kernels).  Captures the G/ref sub-step's ``x_fake``
    and ``x_fake2`` (the generator's first two calls after the G/latent
    update) and prints, per seed and run, their distances from the f32
    run's and from the plain run's and ``G/ref_ds``'s.  The kernel run is
    a fault if it is farther from f32 than 1.5x the plain run at every
    seed, on ``x_fake`` and on ``G/ref_ds`` both."""
    rows = {}
    for seed in STUDY_SEEDS:
        teacher, fakes, ds = {}, {}, {}
        for run in STUDY_RUNS:
            dtype = "float32" if run == "f32" else "bfloat16"
            cfg = small_train_cfg(dtype)
            batch = train_batches(cfg, 1, 2, seed=100 + seed)[0]
            phase, got = {"ref": False}, []

            def hook(sub, by_net):
                phase["ref"] = sub == "G/latent"
                if run == "plain":
                    teacher[sub] = {net: [g.detach().clone() for g in gs] for net, gs in by_net.items()}
                    return None
                return teacher[sub]

            def capture(module, args, out):
                if phase["ref"] and len(got) < 2:
                    got.append(out.detach().float())

            undo = plain_kernels() if run == "plain" else (
                plain_kernels(run.split(":")[1]) if run.startswith("plain:") else (lambda: None))
            try:
                state, frozen, step = build_trainer(cfg, device, grad_hook=hook, seed=seed)
                handle = state.nets["generator"].register_forward_hook(capture)
                losses = step(state, frozen, batch)
                handle.remove()
            finally:
                undo()
            fakes[run], ds[run] = got, float(losses["G/ref_ds"])
        def dist(a, b):
            return max(float((x - y).abs().max() / y.abs().max()) for x, y in zip(a, b))

        for run in BF16_RUNS:
            rows[seed, run] = dict(
                x_fake_vs_f32=dist(fakes[run][:1], fakes["f32"][:1]),
                x_fake2_vs_f32=dist(fakes[run][1:], fakes["f32"][1:]),
                vs_plain=dist(fakes[run], fakes["plain"]) if run != "plain" else 0.0,
                ref_ds_rel=abs(ds[run] - ds["f32"]) / abs(ds["f32"]),
            )
            print(f"ref_ds study seed {seed} {run}: " + json.dumps(rows[seed, run]))
    outlier = {key: all(rows[s, "kernels"][key] > 1.5 * rows[s, "plain"][key] for s in STUDY_SEEDS)
               for key in ("x_fake_vs_f32", "x_fake2_vs_f32", "ref_ds_rel")}
    worst = {run: {key: max(rows[s, run][key] for s in STUDY_SEEDS) for key in rows[STUDY_SEEDS[0], run]}
             for run in BF16_RUNS}
    print(f"ref_ds study: the kernel run farther from f32 than 1.5x the plain run at every seed: {outlier}; "
          f"worst over seeds {json.dumps(worst)}")
    if outlier["x_fake_vs_f32"] and outlier["ref_ds_rel"]:
        raise AssertionError("the bf16 kernel run is the outlier on G/ref's x_fake and G/ref_ds at every seed")
    return rows


INT8_TOPS = 1979e12  # dense int8 tensor-core peak (NVIDIA's data sheet, SXM)


def int8_decode_shapes() -> dict:
    """(B, H, C, O, up) of every int8 product the quantized decoder runs
    (H the input's side; ``up`` the nearest-up2x conv), with its calls a
    served de-id step (R = 10 styles, decode at the source batch of 8)
    at 128^2, and the 256^2 generator's at B = 4 (0 a served step)."""
    shapes = {}
    for b, img, per_style in ((SERVE_BATCH, IMG, R_STYLES), (TRAIN_B, VIDEO_IMG, 0)):
        rn = int(math.log2(img)) - 3
        dims = [2**14 // img]
        for _ in range(rn):
            dims.append(min(2 * dims[-1], 512))
        h = img >> rn
        key = (b, h, dims[-1], dims[-1], False)
        shapes[key] = shapes.get(key, 0) + 4 * per_style
        for i in reversed(range(rn)):
            shapes[b, h, dims[i + 1], dims[i], True] = per_style
            h *= 2
            key = (b, h, dims[i], dims[i], False)
            shapes[key] = shapes.get(key, 0) + per_style
    return shapes


def int8_bound(x, o: int, up: bool) -> tuple[float, str]:
    """x read and the output written in bf16, the int8 weights, 2 x the
    MACs at the int8 rate."""
    b, h, w, c = x.shape
    taps, outs = (16, 4 * b * h * w) if up else (9, b * h * w)
    macs = outs * o * c * (4 if up else 9)
    return bound(2 * x.numel() + 2 * outs * o + taps * c * o + 4 * o, 2 * macs, INT8_TOPS)


def check_int8(torch, dev) -> list[dict]:
    """The int8 decode's products (``ops/quant.py``, ``torch._int_mm``; no
    Pallas kernel) at every shape of ``int8_decode_shapes``: the int32
    accumulators bit for bit against the plain f64 version, the bf16
    outputs bit for bit against the CPU path's on the same inputs, and
    the time of the whole int8 conv (quantize, products, rescale; weights
    quantized once, as the modules cache them) and its device time (all
    its kernels, from the profiler) beside the exact path's
    conv at the same shape: the conv3x3 kernel and ``F.conv2d``
    (channels_last) for a 3x3 conv, the fused ``conv_transpose2d`` for
    the up-conv; and its int8 bound.  One record for each kind at the
    de-id path's 128^2 shape."""
    import torch.nn.functional as F

    from ppvision_tpu_torch.ops import quant
    from ppvision_tpu_torch.ops.fusedconv import conv3x3_nearest_up2x
    from ppvision_tpu_torch.ops.winograd import conv3x3, pack_conv3x3_weight

    g = torch.Generator().manual_seed(6)
    records, step = [], {"int8_ms": 0.0, "exact_ms": 0.0}
    for (b, h, c, o, up), per_step in int8_decode_shapes().items():
        x = torch.randn((b, h, h, c), generator=g).to(dev, torch.bfloat16)
        k = torch.randn((3, 3, c, o), generator=g) / math.sqrt(9 * c)
        kd = k.to(dev)
        wq = (quant.quantize_up2x_weight if up else quant.quantize_weight_per_oc)(kd)
        fn = quant.int8_conv3x3_nearest_up2x if up else quant.int8_conv
        acc_mm = quant.int8_up2x_acc_mm if up else quant.int8_conv_acc_mm
        acc_ref = quant.int8_up2x_acc_ref if up else quant.int8_conv_acc_ref
        xq, _ = quant.quantize_dynamic(x)
        same_acc = torch.equal(acc_mm(xq, wq[0]), acc_ref(xq, wq[0]))
        got = fn(x, kd, wq)
        same_cpu = torch.equal(got.cpu(), fn(x.cpu(), k))
        name = "int8_conv3x3_nearest_up2x" if up else "int8_conv"
        if not (same_acc and same_cpu):
            raise AssertionError(f"{name} at {(b, h, c, o)}: accumulators equal the f64 version's: {same_acc}; "
                                 f"outputs equal the CPU path's: {same_cpu}")
        ms = cuda_ms(lambda: fn(x, kd, wq))
        busy_us = device_us(lambda: fn(x, kd, wq), "")  # every kernel of a call
        x_cl = x.permute(0, 3, 1, 2)
        if up:
            exact = cuda_ms(lambda: conv3x3_nearest_up2x(x_cl, kd.permute(3, 2, 0, 1)))
            line = f"conv_transpose2d {exact:.4f}"
        else:
            wp = pack_conv3x3_weight(kd.to(torch.bfloat16))
            w_oihw = kd.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            exact = cuda_ms(lambda: conv3x3(x, wp))
            lib = cuda_ms(lambda: F.conv2d(x_cl, w_oihw, padding=1))
            line = f"conv3x3 kernel {exact:.4f}, F.conv2d {lib:.4f}"
        bms, by = int8_bound(x, o, up)
        step["int8_ms"] += per_step * ms
        step["exact_ms"] += per_step * exact
        print(f"{name} B={b} {h}x{h} {c}->{o}: {ms:.4f} ms, {busy_us:.1f} us of device time ({line}; int8 bound "
              f"{bms:.4f} by {by}; {per_step} a served step); accumulators and outputs bit for bit")
        if (b, h) == (SERVE_BATCH, 64):
            records.append(dict(
                name=name, route="torch._int_mm", source="ppvision_tpu_torch/ops/quant.py",
                replaces=f"ppvision_tpu/ops/quant.py:{100 if up else 80} (lax conv; no pl.pallas_call, not a port of a "
                         "Pallas kernel)",
                max_abs_err=0.0, path="int8", ms=ms, plain_ms=cuda_ms(lambda: acc_ref(xq, wq[0]), iters=5, warmup=1),
                bound_ms=bms, bound_by=by, library_ms=exact if up else lib, shape=[b, h, h, c, o],
            ))
    print(f"int8 products over a served int8 step's launches: {step['int8_ms']:.4f} ms against the exact path's "
          f"{step['exact_ms']:.4f} ms (conv3x3 kernel and fused up-convs)")
    return records


def serve_int8(torch, kernels, card: str) -> dict:
    """``ModelConfig(img_size=128, quant_decode=True)`` at full width
    through ``DeIdServer`` (batch 8, R = 10), the counts set to 0 just
    before and read just after: the four de-id kernels as in the exact
    served run but conv3x3 ``CONV3X3_INT8_PER_STEP`` times a step (the
    decoder's 8 a style went to int8), and the int8 products as often as
    ``int8_decode_shapes`` says.  Then the int8 output against the exact
    output on the same weights and inputs (``deid_multi_style``, B = 8),
    held to ``1e-5 < rel < 0.25`` (``tests/test_quant.py``), and the
    img/s of both, labelled, at B = 8 and 32 in this call."""
    import dataclasses

    from ppvision_tpu_torch.deid import build_deid, deid_multi_style
    from ppvision_tpu_torch.ops import quant
    from ppvision_tpu_torch.serve import DeIdServer

    cfg = config("bfloat16")
    qcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, quant_decode=True))
    qbundle = build_deid(0, qcfg, device="cuda")
    rng = np.random.default_rng(11)
    x_ref = rng.random((R_STYLES, IMG, IMG, 3), dtype=np.float32)
    y_ref = np.arange(R_STYLES) % 2
    server = DeIdServer(qbundle, x_ref, y_ref, batch_size=SERVE_BATCH, depth=2)
    server.warmup()
    requests = [rng.random((IMG, IMG, 3), dtype=np.float32) for _ in range(3 * SERVE_BATCH - 3)]
    counted = {**kernels, "int8_conv": quant.int8_conv_acc, "int8_up2x": quant.int8_up2x_acc}
    for fn in counted.values():
        fn.launches = 0
    outs = list(server.serve(requests))
    launches = {name: fn.launches for name, fn in counted.items()}
    steps = -(-len(requests) // SERVE_BATCH)
    print(f"int8 served {len(outs)} requests; launches {launches}")
    shapes = int8_decode_shapes()
    want = dict(
        conv3x3=steps * CONV3X3_INT8_PER_STEP, instats=steps * INSTATS_PER_STEP,
        denseblock=steps * DENSEBLOCK_PER_STEP,
        int8_conv=steps * sum(n for k, n in shapes.items() if not k[-1]),
        int8_up2x=steps * sum(n for k, n in shapes.items() if k[-1]),
    )
    bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
    if bad or launches["fftconv"] == 0:
        raise AssertionError(f"int8 served run: launches (got, want) {bad}, fftconv {launches['fftconv']}")
    if any(o.shape != (R_STYLES, IMG, IMG, 3) or not np.isfinite(o).all() for o in outs):
        raise AssertionError("int8 served run: bad output")
    bundle = build_deid(0, cfg, device="cuda")
    rates = {}
    for b in (SERVE_BATCH, 32):
        xs, xr, yr = (t.cuda() for t in seeded_inputs(b, R_STYLES))
        if b == SERVE_BATCH:
            ye, yq = deid_multi_style(bundle, xs, xr, yr), deid_multi_style(qbundle, xs, xr, yr)
            rel = float(torch.linalg.vector_norm(yq - ye) / torch.linalg.vector_norm(ye))
            print(f"int8 against exact output, B={b} R={R_STYLES}: rel {rel:.4e} (bound 1e-5 < rel < 0.25)")
            if not 1e-5 < rel < 0.25 or not bool(torch.isfinite(yq).all()):
                raise AssertionError(f"int8 decode output departs from the exact output: rel {rel}")
            int8_gates(torch, ye, yq)
        for tag, bd in (("exact", bundle), ("int8", qbundle), ("int8 again", qbundle), ("exact again", bundle)):
            ms = cuda_ms(lambda: deid_multi_style(bd, xs, xr, yr), iters=3, warmup=1)
            rates.setdefault((tag.split()[0], b), []).append(b * R_STYLES / (ms / 1e3))
    print(json.dumps({"deid_img_s": {f"{tag} B={b}": v for (tag, b), v in rates.items()},
                      "note": "int8 is the lossy opt-in mode (quant_decode); exact is the default path",
                      "R": R_STYLES, "img": IMG, "card": card}))
    return launches


def remat_check(torch, card: str) -> None:
    """One ``FaceDeIdConfig()`` step (256^2, B = 4) with ``remat=True``
    against the same step without it, from the same seeded state and
    batch, with cuDNN's deterministic algorithms for the phase; a second
    plain run shows what is left of run-to-run noise (the flow loss's
    ``grid_sample`` backward adds with atomics).  Every run applies the
    first run's gradients, so each sub-step starts from the same weights.
    Losses bit for bit (the forwards are deterministic); every gradient at
    cosine >= 0.9999; the step's peak device memory above what was
    allocated before it, and the seconds of a second, steady step."""
    import dataclasses

    from ppvision_tpu_torch.config import FaceDeIdConfig

    batches = train_batches(FaceDeIdConfig(), 2, TRAIN_B, seed=41)
    teacher, grads, out = {}, {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for run in ("plain", "plain again", "remat"):
            cfg = FaceDeIdConfig()
            cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, remat=run == "remat"))
            first = {"on": True}

            def hook(sub, by_net):
                if not first["on"]:
                    return None
                grads[run, sub] = {net: [g.detach().float().clone() for g in gs] for net, gs in by_net.items()}
                if run == "plain":
                    teacher[sub] = grads[run, sub]
                    return None
                return teacher[sub]

            state, frozen, step = build_trainer(cfg, "cuda", grad_hook=hook)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            losses = {k: float(v) for k, v in step(state, frozen, batches[0]).items()}
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - before
            first["on"] = False
            t0 = time.perf_counter()
            step(state, frozen, batches[1])
            torch.cuda.synchronize()
            out[run] = dict(losses=losses, peak_gib=peak / 2**30, steady_s=time.perf_counter() - t0)
            del state, frozen, step
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic

    def cosines(run):
        cos = {}
        for (r, sub), by_net in grads.items():
            if r == run:
                for net, gs in by_net.items():
                    a = torch.cat([t.flatten() for t in gs]).double()
                    b = torch.cat([t.flatten() for t in grads["plain", sub][net]]).double()
                    cos[f"{sub}:{net}"] = float(a @ b / (a.norm() * b.norm() + 1e-30))
        return cos

    diff = {run: {k: abs(out[run]["losses"][k] - v) for k, v in out["plain"]["losses"].items()
                  if out[run]["losses"][k] != v} for run in ("plain again", "remat")}
    cos = {run: cosines(run) for run in ("plain again", "remat")}
    print(json.dumps({"remat": {k: {kk: vv for kk, vv in v.items() if kk != "losses"} for k, v in out.items()},
                      "losses_differing_from_plain": diff, "grad_cosine_to_plain": cos, "B": TRAIN_B,
                      "img": VIDEO_IMG, "card": card}))
    if diff["remat"]:
        raise AssertionError(f"remat: losses differ from the plain step's: {diff['remat']}")
    low = {k: v for k, v in cos["remat"].items() if not v >= 0.9999}
    if low:
        raise AssertionError(f"remat: gradients depart from the plain step's: {low}")


CLI_DIR = os.path.join(OUT_DIR, "cli")
CLI_FACES = 6  # images a class folder
CLI_FACE_HW = (320, 288)  # face-sized, not square: the native crop/resize works on every batch


def write_face_folders(root: str, seed: int, hw=CLI_FACE_HW, n: int = CLI_FACES) -> None:
    """Seeded uint8 (H, W, 3) arrays, ``n`` a class, saved with ``np.save``
    under image names in two class folders (the card's machine has no PIL
    to write or read image files)."""
    rng = np.random.default_rng(seed)
    for cls in ("female", "male"):
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        for i in range(n):
            with open(os.path.join(root, cls, f"{i:03d}.png"), "wb") as f:
                np.save(f, rng.integers(0, 256, (*hw, 3), dtype=np.uint8))


def cli_phase(torch, kernels, card: str) -> dict:
    """``cli/main.py`` on the card at ``FaceDeIdConfig()`` full width
    (256^2, B = 4): ``--mode train`` for 2 iterations from two class
    folders (saving at step 2), a second ``main`` that resumes at step 2
    for a third, then ``--mode sample`` from that checkpoint directory with
    ``--result_dir ''`` (no PNGs: the machine has no PIL) on folders of
    256^2 faces (``eval_batches`` resizes other sizes with PIL).  Only the image
    decoder (``data/face.py::_load_rgb``) is swapped for a reader of the
    arrays ``write_face_folders`` saved; the listing, the balanced
    sampling, the native crop/resize/flip and ``eval_batches`` are the
    package's own, and the native library must build.  Each iteration's
    seconds and launches (the counts set to 0 just before it and read
    just after) are printed; the sample's (R, B, H, W, 3) outputs must be
    finite and equal ``deid_from_reference`` on the restored weights."""
    import shutil

    from ppvision_tpu_torch.cli import main as cli
    from ppvision_tpu_torch.data import face, native
    from ppvision_tpu_torch.deid import build_deid, deid_from_reference
    from ppvision_tpu_torch.ops import DEID_KERNELS
    from ppvision_tpu_torch.train.pretrained import restore_deid_params
    from ppvision_tpu_torch.utils.checkpoint import StepCheckpoints

    if not native.available():
        raise AssertionError("the native transform library (native/transform.cpp) did not build")
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    train_dir, ref_dir, src256, ref256, ck = (os.path.join(CLI_DIR, d) for d in ("train", "ref", "src256", "ref256",
                                                                                  "ckpt"))
    write_face_folders(train_dir, 51)
    write_face_folders(ref_dir, 52)
    write_face_folders(src256, 53, (256, 256))
    write_face_folders(ref256, 54, (256, 256))
    iters = []
    inner_step, inner_load = cli.make_train_step, face._load_rgb

    def timed_step(*args, **kw):
        step = inner_step(*args, **kw)

        def run(state, frozen, batch):
            for fn in kernels.values():
                fn.launches = 0
            at = state.step
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(state, frozen, batch)
            torch.cuda.synchronize()
            iters.append(dict(step=at, seconds=time.perf_counter() - t0,
                              launches={k: fn.launches for k, fn in kernels.items()},
                              batch={k: list(v.shape) for k, v in batch.items()}))
            print(f"cli train iteration from step {at}: {iters[-1]['seconds']:.3f} s; "
                  f"launches {iters[-1]['launches']}; batch {iters[-1]['batch']}")
            bad = [k for k, v in metrics.items() if not math.isfinite(float(v))]
            if bad:
                raise AssertionError(f"cli train: losses not finite: {bad}")
            return metrics

        return run

    common = ["--train_img_dir", train_dir, "--ref_dir", ref_dir, "--checkpoint_save_dir", ck,
              "--checkpoint_dir", os.path.join(CLI_DIR, "none"), "--save_every", "2", "--debug_every", "0",
              "--print_every", "1", "--device", "cuda"]
    cli.make_train_step, face._load_rgb = timed_step, np.load
    try:
        t0 = time.perf_counter()
        cli.main(["--mode", "train", "--total_iters", "2", *common])
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli.main(["--mode", "train", "--total_iters", "3", *common])
        resume_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs = cli.main(["--mode", "sample", "--src_dir", src256, "--ref_dir", ref256,
                         "--checkpoint_save_dir", ck, "--result_dir", "", "--val_batch_size", str(TRAIN_B),
                         "--device", "cuda"])
        sample_s = time.perf_counter() - t0
        src = next(face.eval_batches(src256, 256, TRAIN_B))
        ref = next(face.eval_batches(ref256, 256, TRAIN_B))
    finally:
        cli.make_train_step, face._load_rgb = inner_step, inner_load
    print(f"cli: train 2 iterations {first_s:.1f} s (set-up included), resumed run {resume_s:.1f} s, "
          f"sample {sample_s:.1f} s; iterations {[(i['step'], round(i['seconds'], 3)) for i in iters]}")
    if [i["step"] for i in iters] != [0, 1, 2]:
        raise AssertionError(f"cli train: iterations started at steps {[i['step'] for i in iters]}, not 0, 1, 2")
    print("cli: the second run resumed at step 2")
    missing = [(i["step"], k) for i in iters for k in DEID_KERNELS if i["launches"][k] == 0]
    ckpts = StepCheckpoints(ck)
    groups = [g for g in ("nets", "nets_ema", "optims", "camera") if not os.path.exists(ckpts.path(2, g))]
    if missing or groups or ckpts.latest_step("nets") != 2:
        raise AssertionError(f"cli train: kernels not launched {missing}; groups missing at step 2 {groups}")
    cfg = cli.config_from_args(cli.build_parser().parse_args(["--mode", "sample", "--checkpoint_save_dir", ck]))
    bundle = restore_deid_params(build_deid(cfg.train.seed, cfg, "cuda"), cfg)
    saved = ckpts.load(2, "nets_ema")
    same = all(torch.equal(v.cpu(), saved[n][k].cpu()) for n in saved for k, v in getattr(bundle, n).state_dict().items())
    want = np.stack([deid_from_reference(bundle, torch.from_numpy(src), torch.from_numpy(ref[r : r + 1]).expand(src.shape),
                                         torch.zeros(src.shape[0], dtype=torch.long)).cpu().numpy()
                     for r in range(ref.shape[0])])
    got = outs[0]
    err = float(np.abs(got - want).max()) if got.shape == want.shape else math.inf
    print(f"cli sample: outputs {got.shape}, finite {bool(np.isfinite(got).all())}, restored nets_ema equal the "
          f"saved: {same}; max |sample - deid_from_reference| {err:.3e}")
    if not (same and np.isfinite(got).all() and err <= 1e-3 * max(1.0, float(np.abs(want).max()))):
        raise AssertionError("cli sample: outputs or restored weights wrong")
    print(json.dumps({"cli_train_iteration_s": [i["seconds"] for i in iters], "B": TRAIN_B, "img": 256,
                      "card": card}))
    return dict(launches={k: sum(i["launches"][k] for i in iters) for k in kernels}, iters=iters)


EVAL_DIR = os.path.join(OUT_DIR, "eval")
EVAL_IMAGES = 16  # a domain folder
EVAL_PARTS = ("generation", "lpips", "face_id", "inception", "fid_host")
EVAL_FID_WORKERS = 4  # processes for the FIDs' host sqrtm, beside the card's work
FID_WORKER_THREADS = 1  # BLAS threads a worker: 4 of the card's host's 8 cores, the rest left to the main process
BLAS_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def resize_np(img: np.ndarray, size) -> np.ndarray:
    """Half-pixel bilinear resize of a uint8 (H, W, 3) array, rounded to
    uint8: the stand-in for ``data/face.py::_resize``'s PIL resize (the
    card's machine has no PIL)."""
    from ppvision_tpu_torch.ops.image import _resize_matrix_np

    if img.shape[:2] == tuple(size):
        return img
    mh = _resize_matrix_np(img.shape[0], size[0], False, True)
    mw = _resize_matrix_np(img.shape[1], size[1], False, True)
    out = np.tensordot(np.tensordot(mh, img.astype(np.float64), (1, 0)), mw, (1, 1)).transpose(0, 2, 1)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


class array_io:
    """``data/face.py``'s PIL-bound image I/O swapped for the phase: its
    decoder (``_load_rgb``) reads the arrays ``write_face_folders`` saved
    and its resize (``_resize``) is :func:`resize_np`."""

    def __enter__(self):
        from ppvision_tpu_torch.data import face

        self.saved = face._load_rgb, face._resize
        face._load_rgb, face._resize = np.load, resize_np

    def __exit__(self, *exc):
        from ppvision_tpu_torch.data import face

        face._load_rgb, face._resize = self.saved


class eval_parts:
    """Splits ``calculate_metrics``' seconds on the main process into
    ``EVAL_PARTS`` by timing, between two synchronizes, the names
    ``metrics/eval_gan.py`` calls: ``_generate``, the function
    ``make_pairwise_lpips_fn`` returns, ``_id_cosines`` and
    ``collect_activations`` (the fakes' 299^2 resize included).  The
    FIDs run in worker processes (:func:`timed_fid`); ``fid_host`` is
    filled in from there."""

    NAMES = {"_generate": "generation", "_id_cosines": "face_id", "collect_activations": "inception"}

    def __init__(self, torch):
        self.torch = torch
        self.secs = dict.fromkeys(EVAL_PARTS, 0.0)

    def _timed(self, fn, key):
        def run(*a, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.torch.cuda.synchronize()
            self.secs[key] += time.perf_counter() - t0
            return out

        return run

    def __enter__(self):
        from ppvision_tpu_torch.metrics import eval_gan

        self.saved = {n: getattr(eval_gan, n) for n in (*self.NAMES, "make_pairwise_lpips_fn")}
        for n, key in self.NAMES.items():
            setattr(eval_gan, n, self._timed(self.saved[n], key))
        make = self.saved["make_pairwise_lpips_fn"]
        eval_gan.make_pairwise_lpips_fn = lambda *a, **kw: self._timed(make(*a, **kw), "lpips")
        return self.secs

    def __exit__(self, *exc):
        from ppvision_tpu_torch.metrics import eval_gan

        for n, fn in self.saved.items():
            setattr(eval_gan, n, fn)


def timed_fid(real: np.ndarray, fake: np.ndarray) -> tuple[float, float]:
    """``metrics/fid.py::fid_from_activations`` and its host seconds: the
    eval phase's worker processes run it."""
    from ppvision_tpu_torch.metrics.fid import fid_from_activations

    t0 = time.perf_counter()
    return fid_from_activations(real, fake), time.perf_counter() - t0


def fid_workers():
    """``EVAL_FID_WORKERS`` spawned worker processes, started now with
    ``FID_WORKER_THREADS`` BLAS threads each (the variables are read when
    a process loads numpy, so they are set only while the workers
    start)."""
    import concurrent.futures
    import multiprocessing

    saved = {k: os.environ.get(k) for k in BLAS_THREAD_VARS}
    os.environ.update(dict.fromkeys(BLAS_THREAD_VARS, str(FID_WORKER_THREADS)))
    try:
        pool = concurrent.futures.ProcessPoolExecutor(EVAL_FID_WORKERS, mp_context=multiprocessing.get_context("spawn"))
        for started in [pool.submit(int, 0) for _ in range(EVAL_FID_WORKERS)]:
            started.result()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return pool


def check_eval_results(res: dict, mode: str, tasks=("male2female", "female2male")) -> None:
    """The keys of a two-domain run, every value finite, each cosine in
    [-1, 1] and each LPIPS >= 0."""
    want = {f"{m}_{mode}/{t}" for m in ("LPIPS", "FaceIDcos", "FID") for t in tasks}
    bad = [k for k, v in res.items() if not math.isfinite(v)
           or (k.startswith("FaceIDcos") and not -1.0 <= v <= 1.0) or (k.startswith("LPIPS") and v < 0)]
    if set(res) != want or bad:
        raise AssertionError(f"eval {mode}: keys {sorted(res)} (want {sorted(want)}), bad values {bad}")


def eval_phase(torch, kernels, card: str):
    """``metrics/eval_gan.py::calculate_metrics`` at ``FaceDeIdConfig()``
    (256^2, full width, bf16, FAN at 256; seeded random weights) with the
    full-size random metric nets (``allow_random_metrics``: InceptionV3 at
    299^2, IResNet-50 at 112^2, LPIPS's AlexNet), ``val_batch_size`` 8 and
    ``num_outs_per_domain`` 10, on a val folder of 2 domains x 16 seeded
    256^2 uint8 arrays.  Only ``data/face.py``'s PIL-bound host I/O is
    swapped (:class:`array_io`: ``_load_rgb`` reads the arrays, ``_resize``
    is :func:`resize_np` for the real images' 299^2 path and the
    reference mode); the rest is the package's code.  Runs latent mode,
    reference mode, then latent mode with the aligned face-ID embed (the
    bundle's FAN, as ``tests/test_eval_gan.py`` runs it), each with the
    launch counts set to 0 just before and read just after: the four de-id
    kernels must run, and no conv3x3, instats or denseblock shape that
    their checks did not check.  Each FID (a 2048^2 ``sqrtm`` on the
    host) goes to one of :func:`fid_workers` (:func:`timed_fid`, the
    package's ``fid_from_activations``) while the card goes on.  The
    aligned run draws the same outputs as the first, so its FIDs are the
    first run's, once its activations are checked equal.  Then one source
    batch's multi-output fakes against a per-style loop of
    ``deid_from_latent`` on the same z, bit for bit.  Returns ``finish``,
    which waits for the FIDs, checks every value, prints every key and
    each run's seconds split by ``EVAL_PARTS``, and returns the runs."""
    import concurrent.futures
    import shutil

    from ppvision_tpu_torch.config import FaceDeIdConfig
    from ppvision_tpu_torch.data import face
    from ppvision_tpu_torch.deid import build_deid, deid_from_latent
    from ppvision_tpu_torch.metrics import eval_gan
    from ppvision_tpu_torch.ops import DEID_KERNELS

    t_phase = time.perf_counter()
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    cfg = FaceDeIdConfig()
    size = cfg.model.img_size
    root = os.path.join(EVAL_DIR, "val")
    write_face_folders(root, 61, (size, size), n=EVAL_IMAGES)
    bundle = build_deid(0, cfg, "cuda")
    fid = eval_gan.fid_from_activations
    pool = fid_workers()
    latent_fids, submitted = [], {}

    def submit(tag):
        def run(real, fake):
            submitted.setdefault(tag, []).append(pool.submit(timed_fid, real, fake))
            return submitted[tag][-1]

        return run

    def record(real, fake):
        latent_fids.append((real, fake, submit("latent")(real, fake)))
        return latent_fids[-1][2]

    def reuse(real, fake):
        r, f, v = latent_fids.pop(0)
        err = max(float(np.abs(real - r).max()), float(np.abs(fake - f).max()))
        print(f"eval latent aligned: activations against the latent run's, max |diff| {err:.3e}")
        if err > 1e-3 * max(1.0, float(np.abs(f).max())):
            raise AssertionError(f"eval: the aligned run's outputs differ from the latent run's ({err})")
        return v

    out = {}
    seen, undo = record_shapes()
    try:
        for tag, mode, fan, fid_fn in (("latent", "latent", None, record),
                                       ("reference", "reference", None, submit("reference")),
                                       ("latent aligned", "latent", bundle.fan, reuse)):
            for fn in kernels.values():
                fn.launches = 0
            eval_gan.fid_from_activations = fid_fn
            try:
                with array_io(), eval_parts(torch) as secs:
                    t0 = time.perf_counter()
                    res = eval_gan.calculate_metrics(bundle, root, mode=mode, num_outs=EVAL_R, batch_size=EVAL_B,
                                                     allow_random_metrics=True, align_fan=fan)
                    total = time.perf_counter() - t0
            finally:
                eval_gan.fid_from_activations = fid
            launches = {k: fn.launches for k, fn in kernels.items()}
            missing = [k for k in DEID_KERNELS if launches[k] == 0]
            if missing:
                raise AssertionError(f"eval {tag}: kernels not launched {missing}")
            out[tag] = dict(mode=mode, results=res, seconds=total, parts=dict(secs), launches=launches)
        undo()
        print(f"eval shapes {({k: dict(v) for k, v in seen.items()})}")
        unchecked = unchecked_shapes(seen, ("conv3x3", "instats", "denseblock"))
        if unchecked:
            raise AssertionError(f"the eval phase gave kernel shapes that were not checked: {unchecked}")
        # One source batch: the eval's multi-output path against a loop of
        # deid_from_latent over the same styles' z.
        with array_io():
            x_src = torch.from_numpy(next(face.eval_batches(os.path.join(root, "male"), size, EVAL_B))).cuda()
        y = torch.zeros(EVAL_B, dtype=torch.long).cuda()
        multi = eval_gan._generate(bundle, "latent", x_src, y, np.random.default_rng(5), None, EVAL_R)
        zs = np.random.default_rng(5).standard_normal((EVAL_R, EVAL_B, cfg.model.latent_dim)).astype(np.float32)
        loop = torch.stack([deid_from_latent(bundle, x_src, torch.from_numpy(z).cuda(), y) for z in zs])
        same = bool(torch.equal(multi, loop))
        print(f"eval multi-output fakes against the per-style deid_from_latent loop: bit for bit {same}, max |diff| "
              f"{float((multi - loop).abs().max()):.3e} (mapping network at {EVAL_RB} rows against {EVAL_B})")
        if not same:
            raise AssertionError("eval: the multi-output fakes differ from the per-style loop")
    except BaseException:
        undo()
        pool.shutdown(cancel_futures=True)
        raise
    main_s = time.perf_counter() - t_phase

    def finish() -> dict:
        t_wait = time.perf_counter()
        pool.shutdown(wait=True)
        wait_s = time.perf_counter() - t_wait
        for tag, o in out.items():
            res = o["results"]
            res.update({k: v.result()[0] for k, v in res.items() if isinstance(v, concurrent.futures.Future)})
            fid_s = [f.result()[1] for f in submitted.get(tag, [])]
            o["parts"]["fid_host"] = sum(fid_s)
            check_eval_results(res, o["mode"])
            fids = " + ".join(f"{s:.2f} s" for s in fid_s) or "the latent run's"
            print(f"eval {tag}: {o['seconds']:.2f} s on the main process, "
                  + ", ".join(f"{k} {v:.2f} s" for k, v in o["parts"].items())
                  + f" (FIDs {fids} in worker processes, beside the card's work); launches {o['launches']}; {card}")
            for k, v in res.items():
                print(f"  {k}: {v:.6f}")
        print(f"eval phase: {main_s:.2f} s on the main process; then {wait_s:.2f} s waiting for the FID workers "
              f"({EVAL_FID_WORKERS} processes) after the phases between; {card}")
        print(json.dumps({"eval_s": {k: {"total": v["seconds"], **v["parts"]} for k, v in out.items()},
                          "main_s": main_s, "fid_wait_s": wait_s, "img": size, "B": EVAL_B, "R": EVAL_R,
                          "images_a_domain": EVAL_IMAGES, "card": card}))
        return out

    return finish


def small_eval_cfg():
    """The f32 configuration of ``eval_gpu_vs_cpu``: 64^2, max_conv_dim 64,
    style 16, latent 8, FAN at 64, camera n = 64."""
    from ppvision_tpu_torch.config import CameraConfig, FaceDeIdConfig, ModelConfig

    return FaceDeIdConfig(model=ModelConfig(img_size=64, style_dim=16, latent_dim=8, max_conv_dim=64,
                                            fan_input_size=64, compute_dtype="float32"), camera=CameraConfig(n=64))


EVAL_CARD_CPU_TOL = 1e-3  # tests/test_torch_deid.py's f32 bound


def eval_gpu_vs_cpu(torch) -> dict:
    """``calculate_metrics`` at ``small_eval_cfg`` (2 domains x 4 images,
    batch 4, ``num_outs`` 3, seeded random nets and metric nets) on the card
    and on the port's CPU path, in both modes: every LPIPS and FaceIDcos
    value within ``EVAL_CARD_CPU_TOL``.  The full-size InceptionV3 would
    take the CPU most of a minute a run and a 2048^2 ``sqrtm`` a FID, so
    here ``collect_activations`` gives each image's channel means (the
    fakes' 299^2 resize and normalization still run) and
    ``fid_from_activations`` the squared distance of the means; Inception
    itself is held card against CPU by ``metric_nets_gpu_vs_cpu``.  TF32 is
    off (``resolve_device``)."""
    from ppvision_tpu_torch.deid import build_deid
    from ppvision_tpu_torch.metrics import eval_gan

    root = os.path.join(EVAL_DIR, "small")
    write_face_folders(root, 62, (64, 64), n=4)
    saved = eval_gan.collect_activations, eval_gan.fid_from_activations
    eval_gan.collect_activations = lambda model, batches: np.concatenate(
        [torch.as_tensor(b).float().mean(dim=(1, 2)).cpu().numpy() for b in batches])
    eval_gan.fid_from_activations = lambda real, fake: float(np.sum((real.mean(0) - fake.mean(0)) ** 2))
    res = {}
    try:
        with array_io():
            for dev in ("cuda", "cpu"):
                bundle = build_deid(0, small_eval_cfg(), dev)
                for mode in ("latent", "reference"):
                    res[dev, mode] = eval_gan.calculate_metrics(bundle, root, mode=mode, num_outs=3, batch_size=4,
                                                                allow_random_metrics=True)
    finally:
        eval_gan.collect_activations, eval_gan.fid_from_activations = saved
    errs = {}
    for mode in ("latent", "reference"):
        want = res["cpu", mode]
        for k, v in res["cuda", mode].items():
            errs[k] = abs(v - want[k]) / (1.0 if k.startswith(("LPIPS", "FaceIDcos")) else max(1.0, abs(want[k])))
    worst = max(v for k, v in errs.items() if not k.startswith("FID"))
    print(f"eval card against CPU (64^2 f32, 2x4 images, num_outs 3): max |diff| of LPIPS and FaceIDcos "
          f"{worst:.3e} (tol {EVAL_CARD_CPU_TOL}); of the FID stand-in (relative) "
          f"{max(v for k, v in errs.items() if k.startswith('FID')):.3e}")
    if set(res["cuda", "latent"]) != set(res["cpu", "latent"]) or not worst <= EVAL_CARD_CPU_TOL:
        raise AssertionError(f"eval card against CPU: {errs}")
    return errs


def metric_nets_gpu_vs_cpu(torch) -> dict:
    """InceptionV3 (4 x 299^2), IResNet-50 (4 x 112^2) and LPIPS's AlexNet
    features (4 x 256^2) at full size, seeded random weights, on the card
    and on the CPU in f32: the largest difference relative to the largest
    output within 1e-3.  TF32 stays off (``resolve_device``), so the card
    computes true f32."""
    from ppvision_tpu_torch.metrics.face_id import IResNet
    from ppvision_tpu_torch.metrics.fid import InceptionV3
    from ppvision_tpu_torch.metrics.lpips import LPIPS
    from ppvision_tpu_torch.models.stargan import init_params_

    rng = np.random.default_rng(63)
    lpips = LPIPS()
    init_params_(lpips.alexnet, 0, gain=1.0)
    nets = {"inception": (init_params_(InceptionV3(), 1, gain=1.0), 299),
            "iresnet50": (init_params_(IResNet(), 2, gain=1.0), 112),
            "alexnet": (lpips, 256)}
    errs = {}
    for name, (net, size) in nets.items():
        x = torch.from_numpy(rng.standard_normal((4, size, size, 3)).astype(np.float32))
        fn = (lambda m, v: m.features(v)) if name == "alexnet" else (lambda m, v: [m(v)])
        want = fn(net.eval(), x)
        got = fn(net.cuda(), x.cuda())
        errs[name] = max(float((g.cpu() - w).abs().max()) / (float(w.abs().max()) + 1e-12) for g, w in zip(got, want))
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    print(f"metric nets card against CPU, f32, TF32 (cudnn, matmul) {tf32}: relative max |diff| {errs} (tol 1e-3)")
    if any(not v <= 1e-3 for v in errs.values()):
        raise AssertionError(f"metric nets card against CPU: {errs}")
    return errs


ALIGN_N = 8


def blob_faces(n: int, size: int, seed: int) -> np.ndarray:
    """(n, size, size, 3) faces in [-1, 1]: a smooth blob off centre over
    faint noise, so each landmark heatmap's peak is interior."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] * (256 / size)
    out = []
    for _ in range(n):
        cy, cx = rng.uniform(100, 156, 2)
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 40.0**2))
        out.append(0.6 * blob[..., None] * rng.uniform(0.5, 1, 3) + 0.1 * rng.random((size, size, 3)))
    return (np.stack(out) * 2 - 1).astype(np.float32)


def align_phase(torch, kernels, card: str) -> dict:
    """``models/align.py::FaceAligner`` as ``--mode align`` builds it (the
    full FAN at 256^2, f32, seeded random weights; seeded mean landmarks)
    on ``ALIGN_N`` seeded 256^2 faces, on the card and on the port's CPU
    path: the landmarks identical and the aligned images within 1e-2 on
    the 0-255 scale.  The card's ms an image split into the FAN
    (``get_landmarks``), the mirror-pad and blur (``pad_mirror``) and the
    LANCZOS4 warp, each between two synchronizes, from a second call; the
    FAN runs f32, so denseblock (bf16 only) takes its plain path."""
    from ppvision_tpu_torch.models import align
    from ppvision_tpu_torch.models.fan import FAN
    from ppvision_tpu_torch.models.stargan import init_params_

    fan = init_params_(FAN(), 0, gain=1.0).eval().requires_grad_(False)
    mean_lm = np.tile([[128.0, 128.0]], (98, 1)) + np.random.default_rng(64).normal(0, 30, (98, 2))
    faces = blob_faces(ALIGN_N, 256, 65)
    lms, outs = {}, {}
    for dev in ("cpu", "cuda"):
        aligner = align.FaceAligner(fan.to(dev), mean_lm, 256)
        x = torch.from_numpy(faces).to(dev)
        lms[dev] = align.get_landmarks(aligner.fan, x).cpu().numpy()
        for fn in kernels.values():
            fn.launches = 0
        outs[dev] = aligner.align(faces)
    route = "kernel" if kernels["denseblock"].launches else "plain (the FAN is f32)"
    ms = dict.fromkeys(("fan", "pad_blur", "warp"), 0.0)

    def timed(key, fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        ms[key] += (time.perf_counter() - t0) * 1e3 / ALIGN_N
        return out

    x = torch.from_numpy(faces).cuda()
    lm = timed("fan", align.get_landmarks, aligner.fan, x).cpu().numpy()
    padded = timed("pad_blur", align.pad_mirror, (x * 0.5 + 0.5) * 255.0)
    mats = np.stack([aligner.matrix(m + np.array([padded.shape[2] // 4, padded.shape[1] // 4])) for m in lm])
    timed("warp", align.warp_lanczos4, padded, mats, (256, 256))
    same = int((lms["cuda"] == lms["cpu"]).all(axis=-1).sum())
    err = float(np.abs(outs["cuda"] - outs["cpu"]).max()) * 127.5
    print(f"align {ALIGN_N} x 256^2: landmarks equal card/CPU {same}/{ALIGN_N * 98}; aligned images max |diff| "
          f"{err:.3e} on 0-255 (tol 1e-2); ms an image: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f"; denseblock route {route}; {card}")
    if same != ALIGN_N * 98 or not err <= 1e-2 or not np.isfinite(outs["cuda"]).all():
        raise AssertionError(f"align card against CPU: {same} landmarks equal, images {err}")
    print(json.dumps({"align_ms_an_image": ms, "n": ALIGN_N, "img": 256, "card": card}))
    return dict(ms=ms, err=err)


def int8_gates(torch, ye, yq) -> dict:
    """``tests/test_quant.py::test_quant_task_metrics``' gates on the exact
    and int8 outputs (R, B, H, W, 3) in saved-image space
    (``clip(y * 0.5 + 0.5, 0, 1)``): SSIM > 0.9, and the face-ID cosine with
    a random ``IResNet(layers=(1, 1, 1, 1))`` >= 0.98 and above the cosine
    to uniform noise by 0.3; the cosine with a random IResNet-50 beside."""
    from ppvision_tpu_torch.metrics.face_id import IResNet, face_id_cosine, make_embed_fn
    from ppvision_tpu_torch.metrics.psnr_ssim import ssim
    from ppvision_tpu_torch.models.stargan import init_params_

    dev = ye.device
    e01, q01 = ((y.reshape(-1, *y.shape[2:]) * 0.5 + 0.5).clamp(0, 1) for y in (ye, yq))
    noise = torch.rand(e01.shape, generator=torch.Generator(device=dev).manual_seed(9), device=dev)
    out = {"ssim": float(ssim(e01, q01))}
    for name, layers, seed in (("cos", (1, 1, 1, 1), 3), ("cos_iresnet50", (3, 4, 14, 3), 4)):
        emb = make_embed_fn(init_params_(IResNet(layers=layers), seed, gain=1.0).to(dev).eval())
        out[name] = float(face_id_cosine(emb, e01, q01))
        out[name + "_noise"] = float(face_id_cosine(emb, e01, noise))
    print(f"int8 gates (saved-image space, {e01.shape[0]} images): ssim {out['ssim']:.5f} (> 0.9), face-ID cosine "
          f"{out['cos']:.5f} (>= 0.98; to noise {out['cos_noise']:.5f}), IResNet-50 cosine "
          f"{out['cos_iresnet50']:.5f} (to noise {out['cos_iresnet50_noise']:.5f})")
    if not (out["ssim"] > 0.9 and out["cos"] >= 0.98 and out["cos"] > out["cos_noise"] + 0.3):
        raise AssertionError(f"int8 decode fails its quality gates: {out}")
    return out


# ---------------------------------------------------------------------------
# Captioning (cli/caption.py's path): the lens, the ResNet-101 encoder, the
# attention-LSTM decoder, beam search, training and eval.  No port kernel
# runs on it: the lens's image formation is torch.fft, the trunk cuDNN.
# ---------------------------------------------------------------------------

CAPTION_B = 64  # CaptionConfig().batch_size: the reference recipe's batch
CAPTION_LEN = 52  # tokens a caption: <start>, max_len 50 words, <end>
CAPTION_WORDS = 9490  # entries of the Karpathy COCO word map at min_word_freq=5
CAPTION_STEPS = 3
CAPTION_EVAL_IMAGES = 32
CAPTION_EVAL_BATCH = 16  # evaluate_captions' batch
CAPTION_CPI = 5  # captions an image (COCO's Karpathy split)
CAPTION_CLI_B = 4
CAPTION_DIR = os.path.join(OUT_DIR, "caption")
CAPTION_TEXT_SCORERS = ("bleu_scores", "meteor_avg", "rouge_lsum")  # nltk's; cider_score is pure Python
CAPTION_CARD_CPU_TOL = 1e-5  # f32 metrics and beam scores, relative, card against CPU (TF32 off)
# The f32 step's applied gradients and new BN statistics, relative norm,
# card against CPU.  The encoder's is loose: at this width its layer3-4
# BNs normalize 16-256 values a channel, their input gradients cancel, and
# the card's BN backward accumulates in f32 where the CPU's accumulates
# in f64.  The f64 step holds the card's backward to CAPTION_F64_TOL.
CAPTION_GRAD_TOL = {"camera": 1e-3, "encoder": 1e-2, "decoder": 1e-4, "encoder_bn_stats": 1e-5}
CAPTION_F64_TOL = 1e-10  # the f64 step: metrics relative, gradients and BN statistics relative norm
CAPTION_TRAIN_SPANS = ("caption.camera", "caption.encoder", "caption.decoder", "caption.loss", "caption.optimizer")
CAPTION_EVAL_SPANS = ("caption.camera", "caption.encoder", "caption.beam_search", "caption.image_metrics")


def caption_word_map(n: int = CAPTION_WORDS) -> dict[str, int]:
    """A word map shaped as ``data/caption.py`` writes one: words 1..n-4,
    then <unk>, <start>, <end>, and <pad> = 0 (n entries)."""
    wm = {f"w{i}": i for i in range(1, n - 3)}
    wm.update({"<unk>": n - 3, "<start>": n - 2, "<end>": n - 1, "<pad>": 0})
    return wm


def caption_tokens(rng, n: int, word_map: dict, length: int = CAPTION_LEN) -> tuple[np.ndarray, np.ndarray]:
    """``n`` encoded captions (``<start> w... <end> <pad>*``, ``length`` wide)
    of seeded lengths, the first one full, and their lengths."""
    caps = np.zeros((n, length), np.int32)
    lens = rng.integers(8, length + 1, n).astype(np.int32)
    lens[0] = length
    for i, ln in enumerate(lens):
        caps[i, 0], caps[i, ln - 1] = word_map["<start>"], word_map["<end>"]
        caps[i, 1 : ln - 1] = rng.integers(1, len(word_map) - 3, ln - 2)
    return caps, lens


def smooth_images(n: int, size: int, seed: int) -> np.ndarray:
    """(n, size, size, 3) f32 in [0, 1], each its own seeded smooth image."""
    return np.stack([smooth_frames(1, size, seed + i)[0] for i in range(n)])


class ArrayCaptions:
    """An in-memory caption split with ``CaptionDataset``'s interface
    (``split``, ``cpi``, ``len``, items (image, caption, length[, all
    captions])): the card's machine has no h5py."""

    def __init__(self, split: str, n_images: int, word_map: dict, seed: int, size: int = 256):
        rng = np.random.default_rng(seed)
        self.split, self.cpi = split, CAPTION_CPI
        self.images = smooth_images(n_images, size, seed)
        self.captions, self.caplens = caption_tokens(rng, n_images * self.cpi, word_map)

    def __len__(self):
        return len(self.captions)

    def __getitem__(self, i: int):
        img = self.images[i // self.cpi]
        if self.split == "TRAIN":
            return img, self.captions[i], self.caplens[i]
        lo = (i // self.cpi) * self.cpi
        return img, self.captions[i], self.caplens[i], self.captions[lo : lo + self.cpi]


def caption_host_packages() -> dict:
    """Which of the caption path's host packages import here, and the
    lens's mask rule."""
    import importlib

    def imports(name: str) -> bool:
        try:
            importlib.import_module(name)
        except ImportError:
            return False
        return True

    have = {m: imports(m) for m in ("h5py", "nltk", "cv2", "PIL")}
    print(f"caption host packages: {json.dumps(have)}; the lens's mask rule: "
          f"{'cv2.circle' if have['cv2'] else 'the exact disk r <= 32 (no cv2)'}")
    return have


class nan_text_scores:
    """Without nltk, ``metrics/eval_caption.py``'s BLEU, METEOR and
    ROUGE-Lsum scorers are swapped for stand-ins that return NaN (the
    BLEU-4 save gate then saves nothing); CIDEr stays the real one."""

    def __init__(self, active: bool):
        self.active = active

    def __enter__(self):
        from ppvision_tpu_torch.metrics import eval_caption

        self.saved = {k: getattr(eval_caption, k) for k in CAPTION_TEXT_SCORERS}
        if self.active:
            nan = float("nan")
            eval_caption.bleu_scores = lambda r, h: {f"bleu{i}": nan for i in range(1, 5)}
            eval_caption.meteor_avg = lambda r, h: nan
            eval_caption.rouge_lsum = lambda r, h: nan
            print("caption: no nltk on this machine: BLEU-1..4, METEOR and ROUGE-Lsum report NaN "
                  "(stand-ins); CIDEr, PSNR and SSIM are the real ones; the CLI's BLEU-4 gate saves nothing")

    def __exit__(self, *exc):
        from ppvision_tpu_torch.metrics import eval_caption

        for k, v in self.saved.items():
            setattr(eval_caption, k, v)


def caption_batch(rng, b: int, word_map: dict, dev, size: int = 256) -> dict:
    import torch

    caps, lens = caption_tokens(rng, b, word_map)
    return dict(images=torch.from_numpy(smooth_images(b, size, int(rng.integers(1 << 30)))).to(dev),
                captions=torch.from_numpy(caps).to(dev), caption_lengths=torch.from_numpy(lens).to(dev))


def caption_train(torch, remat: bool) -> dict:
    """``CAPTION_STEPS`` steps of ``make_caption_train_step`` at the recipe
    (``CaptionConfig()``: widths 512, 36x36 features, dropout 0.5, the
    three Adams; ``cli/caption.py::_setup``: ``LensSpec()`` and the
    ResNet-101 in bf16), B = 64, 52-token captions, a 9,490-entry word
    map; seconds a step (host clock, synchronized) and peak GiB."""
    import dataclasses

    from ppvision_tpu_torch.cli import caption as cli
    from ppvision_tpu_torch.config import CaptionConfig
    from ppvision_tpu_torch.train.caption import make_caption_train_step

    cfg = dataclasses.replace(CaptionConfig(), remat=remat)
    dev = "cuda"
    word_map = caption_word_map()
    spec, consts, state = cli._setup(cfg, len(word_map) + 1, dev)
    step = make_caption_train_step(cfg, spec, consts)
    gen = torch.Generator(device=dev).manual_seed(3)
    rng = np.random.default_rng(41)
    batches = [caption_batch(rng, CAPTION_B, word_map, dev) for _ in range(CAPTION_STEPS + 1)]
    before = {k: v.clone() for k, v in state.encoder.state_dict().items()}
    dec_before = {k: v.clone() for k, v in state.decoder.state_dict().items()}
    defocus0 = float(state.camera.defocus.detach())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs, losses = [], []
    for b in batches[:CAPTION_STEPS]:
        t0 = time.perf_counter()
        metrics = step(state, b, gen)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in metrics.items()})
    peak = torch.cuda.max_memory_allocated() / 2**30
    tag = "remat" if remat else "plain"
    for i, (s, m) in enumerate(zip(secs, losses)):
        print(f"caption train ({tag}) step {i}: {s:.3f} s; {json.dumps(m)}")
    sd = state.encoder.state_dict()
    cam_p = state.camera.zernike_coeffs_train
    cam_m = state.opt_camera.state[cam_p]["exp_avg"]
    checks = {
        "finite": all(math.isfinite(v) for m in losses for v in m.values()),
        "camera_gradient": bool(torch.isfinite(cam_m).all() and (cam_m != 0).all()),
        "stem_unchanged": torch.equal(sd["conv1.weight"], before["conv1.weight"])
        and all(torch.equal(sd[k], before[k]) for k in sd if k.startswith("layer1.") and "running" not in k
                and "num_batches" not in k),
        "encoder_moved": not torch.equal(sd["layer4.0.conv2.weight"], before["layer4.0.conv2.weight"]),
        "decoder_moved": not torch.equal(state.decoder.state_dict()["fc.weight"], dec_before["fc.weight"]),
        "bn_stats_changed": all(not torch.equal(sd[k], before[k]) for k in sd if k.endswith("running_var")),
    }
    defocus = float(state.camera.defocus.detach())
    print(f"caption train ({tag}): B {CAPTION_B}, {CAPTION_LEN}-token captions, vocab {len(word_map) + 1}: "
          f"s/step {[round(s, 4) for s in secs]}, peak {peak:.2f} GiB; defocus {defocus0} -> {defocus} (lr "
          f"{cfg.camera_lr}: below half an f32 ulp at -22, ROADMAP.md section 3); checks {json.dumps(checks)}")
    if not all(checks.values()):
        raise AssertionError(f"caption train ({tag}): {checks}")
    profile = None
    if not remat:
        # One more step under the profiler: the device's share of a step,
        # and (a second step) its device time by part.
        profile = device_profile(torch, lambda: step(state, batches[-1], gen), f"caption train step (B {CAPTION_B})",
                                 CAPTION_TRAIN_SPANS)
    return dict(state=state, spec=spec, consts=consts, word_map=word_map, secs=secs, peak_gib=peak,
                losses=losses, profile=profile)


def device_profile(torch, fn, what: str, spans: tuple[str, ...] = ()) -> dict:
    """``fn`` once under ``torch.profiler``, the device's activity only:
    its seconds (synchronized host clock), the device's busy ms and idle
    share, the device ms by kind and the top kernels.  With ``spans``,
    ``fn`` once more with the host's ops recorded too, for
    :func:`device_ms_by_span`."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events) / 1e3
    kinds = {
        "batch_norm": lambda k: "batch_norm" in k or "bn_fw" in k or "bn_bw" in k,
        "cudnn_and_gemm": lambda k: any(n in k for n in ("xmma", "conv", "dgrad", "wgrad", "gemm", "cutlass", "sm90")),
        "fft": lambda k: "fft" in k,
        "elementwise": lambda k: "elementwise" in k,
        "reduce": lambda k: "reduce" in k or "softmax" in k,
    }
    by_kind = {}
    for e in events:
        kind = next((n for n, f in kinds.items() if f(e.key.lower())), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + e.self_device_time_total / 1e3
    line = {"what": what, "s": secs, "device_busy_ms": busy, "device_idle_share": max(0.0, 1 - busy / (secs * 1e3)),
            "device_ms_by_kind": by_kind}
    print(events.table(sort_by="self_device_time_total", row_limit=10, max_name_column_width=60))
    if spans:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        line["device_ms_by_span"], line["backward_device_ms_by_node"] = device_ms_by_span(prof.events(), spans)
    print(json.dumps(line))
    return line


def device_ms_by_span(events, spans: tuple[str, ...]) -> tuple[dict, dict]:
    """Each kernel's device ms to the innermost of ``spans`` (host
    ``record_function`` ranges) around the op that launched it, else to
    ``backward`` if autograd's engine launched it, else to ``other``; and
    the backward's ms by autograd node (the ten largest)."""
    from torch.autograd import DeviceType

    prefix = "autograd::engine::evaluate_function: "
    by_span, by_node = {}, {}
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        ms = sum(k.duration for k in e.kernels) / 1e3
        names, p = [], e
        while p is not None:
            names.append(p.name)
            p = p.cpu_parent
        node = next((n[len(prefix):] for n in reversed(names) if n.startswith(prefix)), None)
        span = next((n for n in names if n in spans), "backward" if node else "other")
        by_span[span] = by_span.get(span, 0.0) + ms
        if node:
            by_node[node] = by_node.get(node, 0.0) + ms
    return by_span, dict(sorted(by_node.items(), key=lambda kv: -kv[1])[:10])


def caption_eval(torch, trained: dict, have: dict, card: str) -> dict:
    """``evaluate_captions`` on 32 in-memory 256^2 images (5 captions
    each), batch 16, beam 5, 50 steps, with the train phase's weights, as
    its two halves: seconds, captions/s, PSNR and SSIM; the device half
    profiled once more for its device ms by part (camera, encoder, beam
    search, image metrics) beside the text metrics' host seconds."""
    from ppvision_tpu_torch.config import CaptionConfig
    from ppvision_tpu_torch.metrics import eval_caption

    st, word_map = trained["state"], trained["word_map"]
    ds = ArrayCaptions("TEST", CAPTION_EVAL_IMAGES, word_map, seed=61)
    cfg = CaptionConfig()

    def decode():
        return eval_caption.decode_captions(cfg, st.encoder, st.decoder, (st.camera, trained["consts"],
                                            trained["spec"]), ds, word_map, batch_size=CAPTION_EVAL_BATCH)

    with nan_text_scores(not have["nltk"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decoded = decode()
        dev_s = time.perf_counter() - t0
        res = eval_caption.score_captions(decoded)
        total = time.perf_counter() - t0
    hyps = decoded["hypotheses"]
    rate = len(hyps) / total
    print(f"caption eval: {len(hyps)} images, batch {CAPTION_EVAL_BATCH}, beam {cfg.beam_size}, "
          f"{cfg.max_caption_len} steps: {total:.3f} s ({rate:.2f} captions/s; device half {dev_s:.3f} s, "
          f"{len(hyps) / dev_s:.2f} captions/s; text metrics {total - dev_s:.4f} s)")
    print(f"caption eval results: {json.dumps(res)}; hypotheses {np.mean([len(h) for h in hyps]):.1f} words "
          f"on average, {sum(not h for h in hyps)} empty")
    profile = device_profile(torch, decode, "caption eval, device half", CAPTION_EVAL_SPANS)
    parts = {**{k.removeprefix("caption."): v for k, v in profile["device_ms_by_span"].items()},
             "text_metrics_host_ms": (total - dev_s) * 1e3}
    words = set(word_map)
    ok = (len(hyps) == CAPTION_EVAL_IMAGES and all(w in words for h in hyps for w in h)
          and all(len(r) == CAPTION_CPI for r in decoded["references"]) and math.isfinite(res["cider"])
          and math.isfinite(res["psnr"]) and 0.0 <= res["ssim"] <= 1.0 and len(decoded["psnrs"]) == len(hyps))
    if not ok:
        raise AssertionError(f"caption eval: results wrong: {res}")
    print(json.dumps({"caption_eval": {"seconds": total, "captions_per_s": rate, "parts_ms": parts,
                                       "psnr": res["psnr"], "ssim": res["ssim"], "cider": res["cider"]},
                      "card": card}))
    return dict(seconds=total, parts_ms=parts, rate=rate, psnr=res["psnr"], ssim=res["ssim"], profile=profile)


def caption_gpu_vs_cpu(torch) -> dict:
    """One train step at a small width (ResNet stages (1, 1, 1, 1), widths
    64, 4x4 features, 64^2 images, the lens at ``LensSpec(128, 64, 16)``
    without height noise, dropout 0, ``camera_lr`` 1e-2, B = 4, a
    200-entry word map) on the card (TF32 off) and on the CPU from the
    same seeded weights and batch, in f32 and in f64: the metrics, each
    module's applied gradient and the encoder's new BN statistics held
    within ``CAPTION_CARD_CPU_TOL`` and ``CAPTION_GRAD_TOL`` in f32 and
    ``CAPTION_F64_TOL`` in f64.  The applied gradient is read from Adam:
    after its first step its ``exp_avg`` is (1 - beta1) times it.  Then
    beam search (beam 5, 20 steps) on the card's updated f32 weights and
    on a CPU copy of them: the tokens identical, the scores within
    ``CAPTION_CARD_CPU_TOL``."""
    import copy

    from ppvision_tpu_torch.config import CaptionConfig
    from ppvision_tpu_torch.models.captioner import beam_search_batch
    from ppvision_tpu_torch.optics.lens import LensSpec, make_lens_constants
    from ppvision_tpu_torch.train.caption import init_caption, make_caption_train_step, make_optimizers

    cfg = CaptionConfig(emb_dim=64, attention_dim=64, decoder_dim=64, encoded_image_size=4, dropout=0.0,
                        camera_lr=1e-2)
    spec = LensSpec(wave_res=128, patch_size=64, zernike_terms=16, height_tolerance=0.0)
    word_map = caption_word_map(200)
    rng = np.random.default_rng(71)
    caps, lens = caption_tokens(rng, 4, word_map, length=14)
    batch = dict(images=torch.from_numpy(smooth_images(4, 64, 72)), captions=torch.from_numpy(caps),
                 caption_lengths=torch.from_numpy(lens))

    def applied(opt) -> torch.Tensor:
        beta1 = opt.param_groups[0]["betas"][0]
        return torch.cat([opt.state[p]["exp_avg"].double().flatten().cpu() / (1 - beta1)
                          for p in opt.param_groups[0]["params"]])

    def one_step(dev: str, dtype):
        state = init_caption(0, cfg, len(word_map) + 1, spec, encoder_stages=(1, 1, 1, 1), device=dev)
        for m in (state.camera, state.encoder, state.decoder):
            m.to(dtype)
        state.opt_camera, state.opt_encoder, state.opt_decoder = make_optimizers(
            cfg, state.camera, state.encoder, state.decoder)
        step = make_caption_train_step(cfg, spec, make_lens_constants(spec, dtype=dtype, device=dev))
        b = {k: v.to(dev, dtype) if v.is_floating_point() else v.to(dev) for k, v in batch.items()}
        metrics = step(state, b, torch.Generator(device=dev).manual_seed(0))
        got = {m: applied(getattr(state, f"opt_{m}")) for m in ("camera", "encoder", "decoder")}
        got["encoder_bn_stats"] = torch.cat([v.double().flatten().cpu() for k, v in state.encoder.state_dict().items()
                                             if k.endswith(("running_mean", "running_var"))])
        return {k: float(v) for k, v in metrics.items()}, got, state

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out, bad = {}, []
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        (mc, gc, _), (mg, gg, card_state) = (one_step(dev, dtype) for dev in ("cpu", "cuda"))
        rel = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-6) for k in mc}
        grad_rel = {m: float((gg[m] - gc[m]).norm() / gc[m].norm()) for m in gc}
        out[name] = dict(rel=rel, grad_rel=grad_rel)
        tol = CAPTION_F64_TOL if dtype == torch.float64 else CAPTION_CARD_CPU_TOL
        grad_tol = dict.fromkeys(gc, CAPTION_F64_TOL) if dtype == torch.float64 else CAPTION_GRAD_TOL
        bad += [f"{name} {k}" for k, v in rel.items() if not v <= tol]
        bad += [f"{name} {m}" for m, v in grad_rel.items() if not v <= grad_tol[m]]
        print(f"caption card vs CPU ({name}, small width): metrics rel {json.dumps(rel)} (tol {tol}); applied "
              f"gradients and BN statistics, relative norm {json.dumps(grad_rel)} (tol {json.dumps(grad_tol)})")
        if dtype == torch.float32:
            f32_decoder = card_state.decoder
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    feats = torch.from_numpy(np.random.default_rng(73).standard_normal((3, 4, 4, 2048), dtype=np.float32))
    cpu_dec = copy.deepcopy(f32_decoder).cpu()
    start, end = word_map["<start>"], word_map["<end>"]
    bs_card = beam_search_batch(f32_decoder.eval(), feats.cuda(), start, end, 5, 20)
    bs_cpu = beam_search_batch(cpu_dec.eval(), feats, start, end, 5, 20)
    same_tokens = torch.equal(bs_card[0].cpu(), bs_cpu[0])
    score_rel = float(((bs_card[1].cpu() - bs_cpu[1]).abs() / bs_cpu[1].abs().clamp_min(1e-6)).max())
    print(f"caption card vs CPU: beam tokens identical {same_tokens}, scores rel {score_rel:.3e}")
    if bad or not same_tokens or not score_rel <= CAPTION_CARD_CPU_TOL:
        raise AssertionError(f"caption on the card departs from the CPU's: {bad}, tokens {same_tokens}")
    return dict(**out, same_tokens=same_tokens, score_rel=score_rel)


def write_caption_split(folder: str, name: str, ds: ArrayCaptions) -> None:
    """``ds`` as the files ``data/caption.py`` writes: the uint8 images in
    HDF5 and the encoded captions and lengths in JSON."""
    import h5py

    with h5py.File(os.path.join(folder, f"{ds.split}_IMAGES_{name}.hdf5"), "w") as h:
        h.attrs["captions_per_image"] = ds.cpi
        h.create_dataset("images", data=np.rint(ds.images * 255).astype(np.uint8))
    for what, arr in (("CAPTIONS", ds.captions), ("CAPLENS", ds.caplens)):
        with open(os.path.join(folder, f"{ds.split}_{what}_{name}.json"), "w") as f:
            json.dump(arr.tolist(), f)


def caption_cli(torch, have: dict) -> dict:
    """``cli/caption.py`` at full width as a user runs it: ``train`` for 1
    epoch of 2 steps at B = 4 (its epoch-end eval on 4 VAL images), then
    ``eval --split TEST`` on 4 images, with ``CaptionDataset`` (HDF5)
    swapped for in-memory splits where h5py does not import, and the
    nltk scorers for NaN stand-ins where nltk does not.  Each step's
    seconds print; ``metrics.jsonl`` and the eval's reports must exist."""
    import shutil

    from ppvision_tpu_torch.cli import caption as cli

    shutil.rmtree(CAPTION_DIR, ignore_errors=True)
    os.makedirs(CAPTION_DIR)
    word_map = caption_word_map()
    name = "coco_5_cap_per_img_5_min_word_freq"
    with open(os.path.join(CAPTION_DIR, f"WORDMAP_{name}.json"), "w") as f:
        json.dump(word_map, f)
    n_images = {"TRAIN": 2 * CAPTION_CLI_B // CAPTION_CPI + 1, "VAL": 4, "TEST": 4}
    saved = cli.CaptionDataset, cli.make_caption_train_step
    iters = []

    def timed_step(*a, **kw):
        step = saved[1](*a, **kw)

        def run(state, batch, gen):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, batch, gen)
            torch.cuda.synchronize()
            iters.append(time.perf_counter() - t0)
            print(f"caption cli train step {len(iters)}: {iters[-1]:.3f} s; batch "
                  f"{ {k: list(v.shape) for k, v in batch.items()} }")
            return out

        return run

    splits = {k: ArrayCaptions(k, n, word_map, seed=80 + len(k)) for k, n in n_images.items()}
    if have["h5py"]:
        for split, ds in splits.items():
            write_caption_split(CAPTION_DIR, name, ds)
    else:
        print("caption cli: no h5py on this machine: CaptionDataset (HDF5) swapped for in-memory splits of "
              f"seeded 256^2 images, {CAPTION_CPI} captions each: {json.dumps(n_images)} images")
        cli.CaptionDataset = lambda folder, base, split: splits[split]
    cli.make_caption_train_step = timed_step
    common = ["--data_folder", CAPTION_DIR, "--data_name", name, "--out_dir", CAPTION_DIR, "--device", "cuda"]
    try:
        with nan_text_scores(not have["nltk"]):
            t0 = time.perf_counter()
            cli.main(["train", *common, "--epochs", "1", "--batch_size", str(CAPTION_CLI_B)])
            train_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = cli.main(["eval", *common, "--split", "TEST", "--max_images", "4"])
            eval_s = time.perf_counter() - t0
    finally:
        cli.CaptionDataset, cli.make_caption_train_step = saved
    ckpt = [f for f in os.listdir(CAPTION_DIR) if f.endswith("_caption_state.ckpt")]
    reports = [f for f in ("metrics.jsonl", "metrics.json", "Captions.txt", "Metrics.txt")
               if not os.path.exists(os.path.join(CAPTION_DIR, f))]
    print(f"caption cli: train {train_s:.1f} s (set-up and the epoch-end eval included), eval {eval_s:.1f} s; "
          f"steps {[round(s, 3) for s in iters]}; checkpoints saved {ckpt}; eval {json.dumps(res)}")
    if len(iters) != 2 or reports or not math.isfinite(res["cider"]) or (not have["nltk"] and ckpt):
        raise AssertionError(f"caption cli: steps {len(iters)}, missing {reports}, checkpoints {ckpt}")
    return dict(train_s=train_s, eval_s=eval_s, steps=iters)


def caption_phase(torch, kernels, card: str) -> dict:
    """The captioning path at full width: train (plain, then remat), the
    eval on the plain run's weights, card against CPU, and the CLI; the
    launch counts set to 0 just before and read just after: no port
    kernel may launch on it.  One JSON line sums it up."""
    have = caption_host_packages()
    for fn in kernels.values():
        fn.launches = 0
    plain = caption_train(torch, remat=False)
    evals = caption_eval(torch, plain, have, card)
    plain.pop("state")
    torch.cuda.empty_cache()
    remat = caption_train(torch, remat=True)
    remat.pop("state")
    torch.cuda.empty_cache()
    vs = caption_gpu_vs_cpu(torch)
    cli_run = caption_cli(torch, have)
    launched = {k: fn.launches for k, fn in kernels.items()}
    print(f"caption phase: port kernel launches {json.dumps(launched)} (the caption path reaches no Pallas kernel)")
    if any(launched.values()):
        raise AssertionError(f"a port kernel launched on the caption path: {launched}")
    summary = {"B": CAPTION_B, "caption_len": CAPTION_LEN, "vocab": CAPTION_WORDS + 1,
               "train_s_per_step": plain["secs"], "train_peak_gib": plain["peak_gib"],
               "train_profile": plain["profile"],
               "remat_s_per_step": remat["secs"], "remat_peak_gib": remat["peak_gib"], "eval": evals,
               "card_vs_cpu": vs, "cli": cli_run, "host_packages": have}
    print(json.dumps({"caption": summary, "card": card}))
    return summary


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)

    import torch

    from ppvision_tpu_torch.ops import DEID_KERNELS, KERNELS, _build

    torch.set_grad_enabled(False)
    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card)
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    phase_s = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        print(f"phase {name}: {phase_s[name]:.1f} s")
        return out

    secs = _build.build_all()
    print(f"kernel build: {secs:.1f} s")
    for name in _build.CUDA_SOURCES:
        report = _build.ptxas_report(name)
        print(report, end="")
        if "C7513" in report or "C7515" in report:
            raise AssertionError(f"ptxas serialized the wgmmas of csrc/{name}.cu")

    t0 = time.perf_counter()
    corr_record, corr_bounds = check_corr(torch, dev)
    records = [*check_fftconv(torch, dev), *check_denseblock(torch, dev),
               *check_instats(torch, dev), *check_conv3x3(torch, dev), corr_record]
    phase_s["kernel_checks"] = time.perf_counter() - t0
    for r in records:
        print(f"{r['name']} {r['shape']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
              f"bound {r['bound_ms']:.4f} by {r['bound_by']}, library {r['library_ms']})")
    launches = phase("serve", serve_main_path, torch, KERNELS, DEID_KERNELS)
    phase("gpu_vs_cpu", gpu_vs_cpu, torch)
    phase("throughput", throughput, torch, card)
    video = phase("video", video_path, torch, KERNELS)
    phase("raft_checks", raft_checks, torch, video["pairs"])
    phase("raft_matmul_conv", raft_matmul_conv, torch)
    phase("raft_throughput", raft_throughput, torch, video["pairs"], card, video["seconds"], corr_bounds)
    phase("train_grads", check_train_grads, torch, dev)
    train = phase("train", train_path, torch, KERNELS, card)
    phase("train_gpu_vs_cpu", train_gpu_vs_cpu, torch, KERNELS)
    int8_records = phase("int8_checks", check_int8, torch, dev)
    int8_launches = phase("int8_serve", serve_int8, torch, KERNELS, card)
    phase("remat", remat_check, torch, card)
    phase("cli", cli_phase, torch, KERNELS, card)
    finish_eval = phase("eval", eval_phase, torch, KERNELS, card)
    phase("ref_ds_study", ref_ds_study, torch, KERNELS)  # the eval's FIDs run beside it on the host
    evals = phase("eval_fids", finish_eval)
    phase("eval_gpu_vs_cpu", eval_gpu_vs_cpu, torch)
    phase("metric_nets_gpu_vs_cpu", metric_nets_gpu_vs_cpu, torch)
    phase("align", align_phase, torch, KERNELS, card)
    phase("caption", caption_phase, torch, KERNELS, card)
    print(json.dumps({"phase_s": phase_s, "build_s": secs, "total_s": time.perf_counter() - t_start, "card": card}))

    # A record takes its launches from the run of its path: the served
    # run, the video phase, the train phase's 3 steps or the eval's
    # latent run.
    runs = {"deid": launches, "video": video["launches"], "train": train["launches"],
            "eval": evals["latent"]["launches"]}
    for r in records:
        r["launches"] = runs[r["path"]][r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "shape")
    # The int8 decode's products (torch._int_mm, no Pallas kernel) on a
    # line of their own, their launches from the int8 served run.
    for r in int8_records:
        r["launches"] = int8_launches["int8_up2x" if r["name"].endswith("up2x") else "int8_conv"]
    print(json.dumps({"int8_products": [{k: r[k] for k in keys} for r in int8_records], "card": card}))
    print(card)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
