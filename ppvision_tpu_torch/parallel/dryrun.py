"""Multi-GPU dry run: one full data-parallel train step of each trainer
(the GAN de-id trainer and the privacy captioner) over N ranks.

Port of ``ppvision_tpu/parallel/dryrun.py``: the batch is split over
the ranks, the parameters, EMA and optimizer state are replicated, and
the gradients are all-reduced (``parallel/mesh.py``).  The GAN step
runs the full paper loss (LPIPS, RAFT flow and the heatmap L1,
solver.py:161-184), at the JAX dry run's tiny shapes.

    python -m ppvision_tpu_torch.parallel.dryrun N [--device cuda|cpu]

spawns N ranks: ``cuda`` (the default) is NCCL over N cards and raises
with fewer; ``cpu`` is gloo.  :class:`Ranks` starts them, each a Python
process of its own, and is how any program of the repo starts ranks on
one machine.
"""

from __future__ import annotations

import argparse
import datetime
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

from .mesh import initialize_multihost, make_mesh, process_slice, replicate, shard_batch

__all__ = ["Ranks", "main", "run", "run_caption"]


def _mesh(n_devices: int, device):
    mesh = make_mesh(device)
    if mesh.world != n_devices:
        raise RuntimeError(f"need a process group of {n_devices} ranks, have {mesh.world}")
    return mesh


def run(n_devices: int, device="cuda") -> dict:
    """One data-parallel GAN train step over the process group's
    ``n_devices`` ranks, two samples a rank: every trained net (G, the
    mapping network, the style encoder, D), the frozen camera and FAN,
    R1's gradient of a gradient, the four Adams and the EMA.  Returns
    the step's (global) metrics."""
    from ..config import CameraConfig, FaceDeIdConfig, LossConfig, ModelConfig
    from ..models.fan import FAN
    from ..models.stargan import init_params_
    from ..optics.camera import Camera, CameraSpec, make_camera_constants
    from ..train.aux_losses import build_flow_fn, build_lpips_fn
    from ..train.gan import FrozenNets, init_gan, make_train_step

    mesh = _mesh(n_devices, device)
    dev = mesh.device
    img = 32  # tiny shapes: still every net and every collective
    cfg = FaceDeIdConfig(
        model=ModelConfig(img_size=img, fan_input_size=64, max_conv_dim=64, style_dim=16),
        camera=CameraConfig(n=img, zernike_terms=32),
        loss=LossConfig(lambda_heatmap=1.0),
    )
    state = init_gan(0, cfg, dev)
    spec = CameraSpec(n=img, zernike_terms=cfg.camera.zernike_terms)
    fan = init_params_(FAN(dtype=getattr(torch, cfg.model.compute_dtype)), 1, gain=1.0)
    fan = fan.to(dev).eval().requires_grad_(False)
    frozen = FrozenNets(camera=Camera(spec, seed=2).to(dev).requires_grad_(False),
                        camera_consts=make_camera_constants(spec, dev), fan=fan, fan_priv=fan)
    lpips_fn, _ = build_lpips_fn(seed=3, device=dev)
    flow_fn, _ = build_flow_fn(seed=4, iters=1, corr_levels=2, corr_radius=2, device=dev)
    replicate(mesh, (state, frozen))

    b = 2 * n_devices
    batch = dict(
        x_src=torch.full((b, img, img, 3), 0.5),
        y_src=torch.zeros((b,), dtype=torch.long),
        x_ref=torch.full((b, img, img, 3), 0.4),
        x_ref2=torch.full((b, img, img, 3), 0.6),
        y_ref=torch.ones((b,), dtype=torch.long),
        z_trg=torch.full((b, cfg.model.latent_dim), 0.1),
        z_trg2=torch.full((b, cfg.model.latent_dim), -0.1),
    )
    rows = process_slice(b, mesh)
    step = make_train_step(cfg, lpips_fn=lpips_fn, flow_fn=flow_fn)
    with mesh:
        metrics = step(state, frozen, shard_batch(mesh, {k: v[rows] for k, v in batch.items()}, local_batch=2))
    if state.step != 1:
        raise AssertionError(f"the step count is {state.step}")
    for k in ("G/ref_lpips", "G/latent_flow", "G/latent_heatmap_l1"):
        if k not in metrics:
            raise AssertionError(f"aux loss {k} missing from the sharded step")
    bad = [k for k, v in metrics.items() if not math.isfinite(float(v))]
    if bad:
        raise AssertionError(f"non-finite metrics {bad}")
    return metrics


def run_caption(n_devices: int, device="cuda") -> dict:
    """One data-parallel caption train step over the process group's
    ``n_devices`` ranks, two samples a rank: the lens (its global-max
    normalize), the BatchNorm encoder (global statistics), the decoder
    and the three optimizers.  Returns the step's (global) metrics."""
    from ..config import CaptionConfig
    from ..optics.lens import LensSpec, make_lens_constants
    from ..train.caption import init_caption, make_caption_train_step

    mesh = _mesh(n_devices, device)
    dev = mesh.device
    cfg = CaptionConfig(emb_dim=16, attention_dim=16, decoder_dim=16, encoded_image_size=4,
                        batch_size=2 * n_devices)
    spec = LensSpec(wave_res=64, patch_size=32, zernike_terms=16)
    state = init_caption(0, cfg, 30, spec, encoder_stages=(1, 1, 1, 1), device=dev)
    replicate(mesh, state)
    step = make_caption_train_step(cfg, spec, make_lens_constants(spec, device=dev))
    b = cfg.batch_size
    batch = dict(
        images=torch.full((b, 32, 32, 3), 0.5),
        captions=torch.ones((b, 10), dtype=torch.long),
        caption_lengths=torch.full((b,), 10),
    )
    rows = process_slice(b, mesh)
    gen = torch.Generator(device=dev).manual_seed(1)
    with mesh:
        metrics = step(state, shard_batch(mesh, {k: v[rows] for k, v in batch.items()}, local_batch=2), gen)
    if state.step != 1:
        raise AssertionError(f"the step count is {state.step}")
    bad = [k for k, v in metrics.items() if not math.isfinite(float(v))]
    if bad:
        raise AssertionError(f"non-finite caption metrics {bad}")
    return metrics


_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CHILD = ("import importlib, sys; m, f = sys.argv[1].split(':'); "
          "getattr(importlib.import_module(m), f)(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:])")


class Ranks:
    """``world`` processes on this machine, rank r calling
    ``fn(r, world, url, *args)``, where ``fn`` names a function as
    ``"module:function"``, ``url`` is a ``file://`` rendezvous under
    ``workdir`` (no port to race for) and ``args`` are strings.  Rank r
    writes its output to ``workdir/rank{r}.log``; torchrun's variables
    are taken out of its environment and ``env`` is added.  The caller
    may work while the ranks run; :meth:`wait` then waits for them, kills
    any still running once ``timeout`` seconds have passed since the
    start, and raises with the failed ranks' logs."""

    def __init__(self, fn: str, world: int, workdir: str, args=(), timeout: float = 600.0,
                 env: dict | None = None):
        self.world, self.workdir = world, os.path.abspath(workdir)
        self.url = "file://" + os.path.join(self.workdir, "rendezvous")
        base = {k: v for k, v in os.environ.items()
                if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        base["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, base.get("PYTHONPATH")) if p)
        base.update(env or {})
        self.logs = [os.path.join(self.workdir, f"rank{r}.log") for r in range(world)]
        self.deadline = time.monotonic() + timeout
        self.procs = []
        for r in range(world):
            with open(self.logs[r], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c", _CHILD, fn, str(r), str(world), self.url, *map(str, args)],
                    env=base, stdout=log, stderr=subprocess.STDOUT))

    def kill(self) -> None:
        """End every rank still running."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def wait(self) -> None:
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            self.kill()
        bad = [r for r, p in enumerate(self.procs) if p.returncode != 0]
        if bad:
            tails = "".join(f"--- rank {r} (exit {self.procs[r].returncode}):\n{open(self.logs[r]).read()[-6000:]}"
                            for r in bad)
            raise RuntimeError(f"ranks {bad} of {self.world} failed\n{tails}")


def _rank(rank: int, world: int, url: str, device: str) -> None:
    dev = f"cuda:{rank}" if device == "cuda" else "cpu"
    if dev == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    initialize_multihost(url, world, rank, device=dev, timeout=datetime.timedelta(seconds=300))
    try:
        run(world, dev)
        run_caption(world, dev)
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", type=int, nargs="?", default=8, help="ranks")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.device == "cuda":
        from ..utils.device import resolve_device

        resolve_device("cuda")
        have = torch.cuda.device_count()
        if have < args.n:
            raise RuntimeError(f"need {args.n} GPUs for {args.n} NCCL ranks, have {have}")
    with tempfile.TemporaryDirectory() as tmp:
        Ranks("ppvision_tpu_torch.parallel.dryrun:_rank", args.n, tmp, (args.device,)).wait()
    print(f"dryrun OK on {args.n} ranks ({args.device}): gan + caption")


if __name__ == "__main__":
    main()
