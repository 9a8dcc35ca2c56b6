"""De-identification traffic through the port's ``DeIdServer``.

One driver for every de-id mix.  The mix file says:

- ``loop``: ``closed`` (a release job: the server drains an iterable as
  fast as it pulls, no flush deadline) or ``open`` (independent users:
  requests due at seeded Poisson times at ``rate_per_s``, pulled by the
  server's own thread, with its flush deadline ``max_wait_s``);
- ``batch_size``, ``depth``, ``out_space``, ``styles`` (R reference
  faces, domains alternating), ``pool`` (seeded sources, drawn in a
  seeded order), ``check_batches``.

Each source's outputs (R uint8 images) arrive on the host in order.  A
closed loop counts the images delivered by the end of the window; an
open loop times every request due in the window from its due time to
its result on the host, waiting for the last one after the close.
Outputs are dropped as they arrive, except those of ``check_batches``
batches drawn by a seeded reservoir, which the reference judges on the
same padded batches (the padding repeats a batch's last source).
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import numpy as np
import torch

from .. import inputs, weights
from ..reference import deid as ref
from ..work import flops

__all__ = ["prepare", "drive", "free", "judge", "work"]

MODULES = ("camera", "fan", "generator", "mapping_network", "style_encoder")
# What the harness's tests read of this driver.  ``TOY``: the entries of
# the configuration and the mix that the CPU rehearsal changes, small
# enough to run a whole cell in seconds on a few CPU threads
# (``rate_per_s`` is the open loop's).  ``CONTROLS``: the variants a
# stated precision lower that must read not correct at the cell's own
# size on the card.  ``FAULTS``: the variants that a CPU rehearsal must
# read not correct; none, since the de-id faults patch the program's
# functions and are tests of their own.
TOY = {
    "config": {"model": {"img_size": 64, "max_conv_dim": 64, "compute_dtype": "float32"},
               "camera": {"n": 64, "zernike_terms": 10}},
    "mix": {"pool": 6, "styles": 2, "batch_size": 2, "check_batches": 2, "rate_per_s": 30.0},
}
CONTROLS = ("int8",)
FAULTS = ()


@dataclasses.dataclass
class Cell:
    cfg: dict
    mix: dict
    seed: int
    device: torch.device
    states: dict
    pool: torch.Tensor  # (P, n, n, 3) on the device, for the reference
    pool_host: list
    x_ref: torch.Tensor
    y_ref: torch.Tensor
    bundle: object = None
    server: object = None
    kept: dict = dataclasses.field(default_factory=dict)  # batch -> {member: (R, n, n, 3) uint8}
    batches: list = dataclasses.field(default_factory=list)  # batch -> [pool index of each member]


def _port_config(cfg: dict, variant: str | None):
    from ppvision_tpu_torch.config import CameraConfig, FaceDeIdConfig, ModelConfig

    m = dict(cfg["model"])
    model = ModelConfig(**{k: m[k] for k in ("img_size", "num_domains", "latent_dim", "hidden_dim", "style_dim",
                                             "w_hpf", "max_conv_dim", "compute_dtype")},
                        quant_decode=variant == "int8")
    cam = cfg["camera"]
    return FaceDeIdConfig(model=model, camera=CameraConfig(n=cam["n"], zernike_terms=cam["zernike_terms"]))


def prepare(cfg: dict, mix: dict, seed: int, device, variant: str | None = None) -> Cell:
    """Build the port's pipeline and server, load the benchmark's weights
    into it, make the inputs, and warm the server's one batch shape."""
    from ppvision_tpu_torch.deid import build_deid
    from ppvision_tpu_torch.serve import DeIdServer

    if variant not in (None, "int8"):
        raise ValueError(f"de-id cells know the variant 'int8' only, not {variant!r}")
    bundle = build_deid(seed, _port_config(cfg, variant), device)
    mods = {k: getattr(bundle, k) for k in MODULES}
    shapes = {k: {n: tuple(t.shape) for n, t in m.state_dict().items()} for k, m in mods.items()}
    states = weights.make_states(shapes, cfg["init"], seed, bundle.device)
    for k, m in mods.items():
        m.load_state_dict(states[k])
    n = cfg["model"]["img_size"]
    r = mix["styles"]
    pool = inputs.smooth_images(mix["pool"], n, seed, bundle.device, stream=1)
    x_ref = inputs.smooth_images(r, n, seed, bundle.device, stream=2)
    y_ref = torch.arange(r, device=bundle.device) % cfg["model"]["num_domains"]
    pool_np = pool.cpu().numpy()
    server = DeIdServer(bundle, x_ref.cpu().numpy(), y_ref.cpu().numpy(), batch_size=mix["batch_size"],
                        depth=mix["depth"], out_space=mix["out_space"])
    server.warmup()
    # One batch through serve itself: its host path (stacking, pinned upload, drain) warms too.
    for _ in server.serve(iter(pool_np[: mix["batch_size"]]), mix.get("max_wait_s")):
        pass
    server.reset_stats()
    if bundle.device.type == "cuda":
        torch.cuda.synchronize()
    return Cell(cfg, mix, seed, bundle.device, states, pool, list(pool_np), x_ref, y_ref, bundle, server)


def _due_times(mix: dict, seconds: float, seed: int) -> np.ndarray:
    """Request due times (seconds from the window's start): N = rate x
    seconds gaps, the same set for every seed (the exponential's
    quantiles, scaled to end at the window's close) in a seeded order."""
    rate = float(mix["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps *= seconds / gaps.sum()
    inputs.seed_rng(seed, 3).shuffle(gaps)
    return np.cumsum(gaps)


def drive(cell: Cell, seconds: float, window) -> dict:
    """The measured window; ``window`` is a context manager that marks
    it (a profiler range in a traced run)."""
    mix, server, pool = cell.mix, cell.server, cell.pool_host
    b, r = mix["batch_size"], mix["styles"]
    open_loop = mix["loop"] == "open"
    rng = inputs.seed_rng(cell.seed, 4)
    k = mix["check_batches"]
    pulled: list[int] = []
    lateness: list[float] = []
    arrivals: list[float] = []
    offsets = _due_times(mix, seconds, cell.seed) if open_loop else None
    sel = inputs.seed_rng(cell.seed, 5).integers(0, len(pool), 10**6)
    t_end, due = 0.0, None

    def closed():
        # Pull until the close, then on to the end of that batch: the job
        # ends on a whole batch, so the images and the seconds to deliver
        # them both count whole batches.
        i = 0
        while time.perf_counter() < t_end or i % b:
            pulled.append(int(sel[i]))
            yield pool[sel[i]]
            i += 1

    def opened():
        for i, t in enumerate(due):
            wait = t - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            lateness.append(time.perf_counter() - t)
            pulled.append(int(sel[i]))
            yield pool[sel[i]]

    done_prev, batch, member, keep = 0, -1, 0, False
    with window():
        t0 = time.perf_counter()
        t_end = t0 + seconds
        if open_loop:
            due = offsets + t0
        for out in server.serve(opened() if open_loop else closed(), mix.get("max_wait_s")):
            now = time.perf_counter()
            arrivals.append(now)
            # The server's count of completed requests, read as it stands:
            # it grows as a batch is drained, before that batch's outputs.
            done = server._completed
            if done != done_prev:  # the first output of the next batch
                batch += 1
                cell.batches.append(list(range(done_prev, done)))
                member, done_prev = 0, done
                # A seeded reservoir of k batches, uniform over those served.
                keep = batch < k or rng.random() < k / (batch + 1)
                if keep:
                    if len(cell.kept) >= k:
                        cell.kept.pop(list(cell.kept)[rng.integers(len(cell.kept))])
                    cell.kept[batch] = {}
            if keep:
                cell.kept[batch][member] = np.array(out)
            member += 1
        if cell.device.type == "cuda":
            torch.cuda.synchronize()
        t_drained = time.perf_counter()
    cell.batches = [[pulled[i] for i in members] for members in cell.batches]
    stats = server.stats()
    n_req = len(pulled)
    res = dict(attempted=n_req, failed=n_req - len(arrivals), counters=stats, drained_s=t_drained - t0,
               outputs=len(arrivals) * r)
    if open_loop:
        lat = [1e3 * (a - d) for a, d in zip(arrivals, due)]
        res["metrics"] = {"latency_p95_ms": float(np.percentile(lat, 95, method="linear"))} if lat else {}
        res["notes"] = dict(requests=n_req, latency_p50_ms=statistics.median(lat) if lat else None,
                            latency_max_ms=max(lat) if lat else None,
                            generator_late_ms_p50=1e3 * statistics.median(lateness) if lateness else None,
                            generator_late_ms_max=1e3 * max(lateness) if lateness else None,
                            rate_per_s=mix["rate_per_s"], due=len(due),
                            answered_by_close=sum(1 for a in arrivals if a <= t_end))
    else:
        # Every image pulled in the window, over the seconds from its start
        # to the last image on the host.
        res["metrics"] = {"images_per_s": len(arrivals) * r / (arrivals[-1] - t0)} if arrivals else {}
        res["notes"] = dict(sources=n_req, images_delivered=len(arrivals) * r, window_s=arrivals[-1] - t0)
    return res


def free(cell: Cell) -> None:
    cell.server = None
    cell.bundle = None


def judge(cell: Cell, res: dict) -> tuple[list, dict]:
    """The kept outputs against the reference run on the same padded
    batches, in uint8 levels: the share of output values that lie
    ``far_levels`` or more from the reference's is compared; the gap's
    other quantiles, the worst image's mean gap and the RMS gap are
    reported beside it.  Returns (the numbers compared with their
    limits, further readings)."""
    b = cell.mix["batch_size"]
    limits = cell.cfg.get("limits", {})
    far = int(limits.get("far_levels", 64))
    sq = ref_sq = 0.0
    per_image: list[torch.Tensor] = []
    count = n_vals = 0
    hist = torch.zeros(256, dtype=torch.float64)
    with torch.no_grad():
        for j, got in sorted(cell.kept.items()):
            members = cell.batches[j]
            idx = members + [members[-1]] * (b - len(members))
            want = ref.to_uint8(ref.deid_batch(cell.states, cell.cfg, cell.pool[idx], cell.x_ref, cell.y_ref))
            for m, out in got.items():
                a = torch.from_numpy(out).to(cell.device)
                a = (a if a.dtype == torch.uint8 else ref.to_uint8(a)).float()
                w = want[:, m].float()
                d = a - w
                sq += float((d * d).sum())
                ref_sq += float((w * w).sum())
                per_image.append(d.abs().mean(dim=(1, 2, 3)).cpu())
                hist += torch.bincount(d.abs().flatten().long(), minlength=256).double().cpu()
                n_vals += d.numel()
                count += 1
    tail = hist.flip(0).cumsum(0).flip(0) / max(n_vals, 1)  # share of values with |gap| >= k levels
    images = torch.cat(per_image) if per_image else torch.zeros(1)
    worst = float(images.max())
    info = {"outputs_checked": count, "batches_checked": len(cell.kept),
            **{f"share_gap_ge_{k}": float(tail[k]) for k in (1, 4, 8, 16, 32, 64, 128)},
            **{f"image_gap_q{q}": float(torch.quantile(images, q / 100)) for q in (10, 50, 90)}}
    info.update(worst_image_mean_abs_gap=worst, rel_rms_gap=(sq / max(ref_sq, 1e-30)) ** 0.5)
    compared = [
        ("outputs_unchecked", float(count == 0), 0.0),
        ("unanswered", float(res["failed"]), 0.0),
        ("share_far", float(tail[far]), limits.get("share_far")),
    ]
    return compared, info


def work(cell: Cell) -> dict:
    """FLOPs an output and the kernels' taped shapes of one batch, from
    the reference on meta tensors."""
    b, r = cell.mix["batch_size"], cell.mix["styles"]
    total, tape = flops.count(ref.counted_batch, cell.states, cell.cfg, b, r)
    return dict(flops_per_output=total / (b * r), tape_per_batch=tape, batch_size=b, styles=r)

