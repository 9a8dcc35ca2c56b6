"""Readings of the program's own ``record_function`` ranges, shared by
the per-layer readers in ``layer_metrics/``.

Built on a :class:`portbench.trace.Trace`'s public ``window`` and
``device`` and on the profiler's events, read in one pass a run:

- device ms a batch of the program's leaf ranges (no one nests another):
  the device's busy time inside the profiler's device-side copy of each
  range (the interval from the first to the last device activity that a
  launch inside the range made).  Not ``Trace.span_ms``: the port's own
  CUDA kernels launch through ``ctypes`` outside any aten op, so the
  trace links them to no host op and ``span_ms`` charges them to
  ``other`` (24.5 of 204 device ms a release batch on an H100), while
  the device-side copies hold them;
- device idle ms inside ranges of the main thread (the thread that holds
  the window's range): the idle intervals of the window (its length
  less the union of device activity) intersected with the union of
  those ranges, split at every edge, on the profiler's one clock;
- host ms a batch from the server's ``stats()`` counters.

Every reading is None where there is nothing to read: no batch or step
in the window, no device activity (a run on the CPU), or none of the
ranges (a program without them).
"""

from __future__ import annotations

from .trace import WINDOW

__all__ = ["SERVE_HOST", "counter_ms_per_batch", "device_ms", "idle_ms", "overlap_ns"]

# The server's host path of a batch on the main thread (serve.py).
SERVE_HOST = ("serve.assemble", "serve.upload", "serve.launch")
# Name prefixes of the program's ranges.
_PROGRAM = ("deid.", "serve.", "caption.")


def _per(ctx, key: str) -> int:
    """The run's count of batches (``batches_dispatched``) or steps."""
    if key == "steps":
        return int(ctx.res.get("steps") or 0)
    return int(ctx.res.get("counters", {}).get(key) or 0)


def counter_ms_per_batch(ctx, keys: tuple[str, ...]) -> float | None:
    """Milliseconds a batch of the summed ``stats()`` counters ``keys``
    (host seconds)."""
    c = ctx.res.get("counters", {})
    n = _per(ctx, "batches_dispatched")
    if not n or any(k not in c for k in keys):
        return None
    return 1e3 * sum(c[k] for k in keys) / n


def _merged(intervals) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        elif t > s:
            out.append([s, t])
    return [(s, t) for s, t in out]


def overlap_ns(a: list, intervals) -> int:
    """The length of the intersection of ``a`` (sorted, disjoint
    intervals) with the union of ``intervals``."""
    b = _merged(intervals)
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _timeline(ctx) -> dict:
    """The window's busy and idle intervals, and the program's ranges by
    name on the main thread (``host``) and on the device (``device``,
    clipped to the window); read once a run and kept on ``ctx``."""
    if getattr(ctx, "timeline", None) is not None:
        return ctx.timeline
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
        if not name.startswith(_PROGRAM):
            continue
        s = e.start_ns()
        t = s + e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            if e.start_thread_id() == main:
                host.setdefault(name, []).append((s, t))
        elif e.device_type() == DeviceType.CUDA and min(t, b) > max(s, a):
            device.setdefault(name, []).append((max(s, a), min(t, b)))
    ctx.timeline = dict(busy=busy, idle=idle, host=host, device=device)
    return ctx.timeline


def device_ms(ctx, names: tuple[str, ...], per: str = "batches_dispatched") -> float | None:
    """Device busy ms a batch (or step) inside the device-side copies of
    the ranges ``names``, leaves that nest no range of the program."""
    n = _per(ctx, per)
    if not n or not ctx.trace.device:
        return None
    tl = _timeline(ctx)
    ranges = [iv for name in names for iv in tl["device"].get(name, ())]
    return overlap_ns(tl["busy"], ranges) / 1e6 / n if ranges else None


def idle_ms(ctx, names: tuple[str, ...], per: str = "batches_dispatched") -> float | None:
    """Device idle ms a batch (or step) that fall inside the main thread's
    ranges ``names``."""
    n = _per(ctx, per)
    if not n or not ctx.trace.device:
        return None
    tl = _timeline(ctx)
    ranges = [iv for name in names for iv in tl["host"].get(name, ())]
    return overlap_ns(tl["idle"], ranges) / 1e6 / n if ranges else None
