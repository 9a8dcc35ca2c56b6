"""Observability: meters, metric writers, profiler traces.

Port of ``ppvision_tpu/utils/logging.py`` (the reference's console
printf and opt-in wandb, solver.py:196-209; ``AverageMeter``,
Image_Caption/utils.py:412-430): one writer for the console, a
``metrics.jsonl`` file and, where installed, wandb and tensorboard.
``profile_trace`` runs ``torch.profiler`` over its block and writes a
Chrome trace (``chrome://tracing``, Perfetto) into its directory; the
trace carries the program's ``deid.*``, ``serve.*`` and ``caption.*``
ranges.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any

__all__ = ["AverageMeter", "MetricWriter", "profile_trace"]


class AverageMeter:
    """Running average (reference utils.py:412-430)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class MetricWriter:
    """Console + JSONL metric writer with optional wandb / tensorboard
    passthrough.  Scalars go out every ``log_interval`` steps;
    ``write_image`` logs an image where wandb or tensorboard is on.  A
    requested backend that is not installed prints one notice and is
    left out."""

    def __init__(
        self,
        log_dir: str | None = None,
        use_wandb: bool = False,
        log_interval: int = 10,
        prefix: str = "",
        use_tensorboard: bool = False,
    ):
        self.log_interval = log_interval
        self.prefix = prefix
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a", buffering=1)
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
            except ImportError:
                print("wandb requested but not installed; console/jsonl only")
        self._tb = None
        if use_tensorboard and log_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(log_dir, "tb"))
            except ImportError:
                print("tensorboard requested but not installed; console/jsonl only")
        self._start = time.time()

    def write(self, step: int, metrics: dict[str, Any], force: bool = False):
        if not force and step % self.log_interval != 0:
            return
        scalars = {k: float(v) for k, v in metrics.items()}
        elapsed = time.time() - self._start
        line = " ".join(f"{k}: [{v:.4f}]" for k, v in scalars.items())
        print(f"[{elapsed:8.1f}s] step {step}: {line}")
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": step, **scalars}) + "\n")
        if self._wandb:
            self._wandb.log(scalars, step=step)
        if self._tb:
            for k, v in scalars.items():
                self._tb.add_scalar(self.prefix + k, v, step)

    def write_image(self, step: int, name: str, image) -> None:
        """Log an (H, W, C) [0,1] image to wandb/tensorboard if active."""
        import numpy as np

        arr = np.clip(np.asarray(image, np.float32), 0.0, 1.0)
        if self._wandb:
            self._wandb.log({name: self._wandb.Image(arr)}, step=step)
        if self._tb:
            self._tb.add_image(name, arr, step, dataformats="HWC")

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """``torch.profiler`` over the block (host ops, and the device's
    kernels where there is a GPU), written as a Chrome trace
    ``trace_<pid>_<time>.json`` into ``log_dir``."""
    if not enabled:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
