"""Readings of the GAN trainer's ``gan.*`` ranges (``train/gan.py``),
shared by the readers of the ``deid256-train`` cell.

The rules of :mod:`portbench.spans`, for the ranges whose names start
with ``gan.``: device ms a step inside the profiler's device-side copies
of the ranges (the union of the device's busy intervals inside them),
and device idle ms a step inside the main thread's host ranges (the
window's idle intervals intersected with them).  Each reading is None
where there is nothing to read: no step in the window, no device
activity (a run on the CPU), or none of the ranges (a program without
them).
"""

from __future__ import annotations

from .spans import _merged, overlap_ns
from .trace import WINDOW

__all__ = ["device_ms", "idle_ms"]

PREFIX = "gan."


def _timeline(ctx) -> dict:
    """The window's busy and idle intervals and the ``gan.*`` ranges by
    name, on the main thread (``host``) and on the device (``device``,
    clipped to the window); read once a run and kept on ``ctx``."""
    if getattr(ctx, "gan_timeline", None) is not None:
        return ctx.gan_timeline
    from torch.autograd import DeviceType

    trace = ctx.trace
    a, b = trace.window
    busy = _merged((s, t) for s, t, _ in trace.device)
    edges = [a] + [x for iv in busy for x in iv] + [b]
    idle = [(s, t) for s, t in zip(edges[0::2], edges[1::2]) if t > s]
    events = trace.prof.profiler.kineto_results.events()
    main = next(e.start_thread_id() for e in events if e.name() == WINDOW and e.device_type() == DeviceType.CPU)
    host: dict[str, list] = {}
    device: dict[str, list] = {}
    for e in events:
        name = e.name()
        if not name.startswith(PREFIX):
            continue
        s = e.start_ns()
        t = s + e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            if e.start_thread_id() == main:
                host.setdefault(name, []).append((s, t))
        elif e.device_type() == DeviceType.CUDA and min(t, b) > max(s, a):
            device.setdefault(name, []).append((max(s, a), min(t, b)))
    ctx.gan_timeline = dict(busy=busy, idle=idle, host=host, device=device)
    return ctx.gan_timeline


def _steps(ctx) -> int:
    return int(ctx.res.get("steps") or 0)


def device_ms(ctx, names: tuple[str, ...]) -> float | None:
    """Device busy ms a step inside the device-side copies of ``names``
    (the union over them: a nested range adds nothing twice)."""
    n = _steps(ctx)
    if not n or not ctx.trace.device:
        return None
    tl = _timeline(ctx)
    ranges = [iv for name in names for iv in tl["device"].get(name, ())]
    return overlap_ns(tl["busy"], ranges) / 1e6 / n if ranges else None


def idle_ms(ctx, names: tuple[str, ...]) -> float | None:
    """Device idle ms a step inside the main thread's ranges ``names``."""
    n = _steps(ctx)
    if not n or not ctx.trace.device:
        return None
    tl = _timeline(ctx)
    ranges = [iv for name in names for iv in tl["host"].get(name, ())]
    return overlap_ns(tl["idle"], ranges) / 1e6 / n if ranges else None
