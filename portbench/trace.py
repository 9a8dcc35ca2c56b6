"""Reading a ``torch.profiler`` trace of the measured window.

The window is marked by a ``record_function`` range named
:data:`WINDOW`.  From the trace's device activity (kernels, copies and
memsets) this module takes the union of busy intervals inside the
window, the device time by operation name, and the idle gaps, each
named after the innermost host range or op running at the gap's
middle.  :func:`Trace.span_ms` charges each kernel to the innermost of
given host ranges around the op that launched it, else to ``backward``
where autograd's engine launched it, else to ``other`` (the rule of the
port's ``chip_smoke.device_ms_by_span``).
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
from functools import cached_property

__all__ = ["WINDOW", "Trace"]

WINDOW = "portbench.window"
_ENGINE = "autograd::engine::evaluate_function: "


def _annotation(e) -> bool:
    """A user range mirrored on the device's timeline, not device work."""
    kind = getattr(e, "activity_type", None)
    return e.is_user_annotation() or (kind is not None and "annotation" in str(kind()).lower())


@dataclasses.dataclass
class Trace:
    prof: object  # torch.profiler.profile, stopped
    _spans: dict = dataclasses.field(default_factory=dict)

    @cached_property
    def _events(self):
        return list(self.prof.profiler.kineto_results.events())

    @cached_property
    def window(self) -> tuple[int, int]:
        """(start, end) of the window range, trace nanoseconds."""
        from torch.autograd import DeviceType

        for e in self._events:
            if e.name() == WINDOW and e.device_type() == DeviceType.CPU:
                return e.start_ns(), e.start_ns() + e.duration_ns()
        raise RuntimeError(f"the trace has no {WINDOW!r} range")

    @property
    def window_s(self) -> float:
        a, b = self.window
        return (b - a) / 1e9

    @cached_property
    def device(self) -> list[tuple[int, int, str]]:
        """(start, end, name) of every device activity inside the window,
        clipped to it, sorted by start."""
        from torch.autograd import DeviceType

        a, b = self.window
        out = []
        for e in self._events:
            if e.device_type() != DeviceType.CUDA or _annotation(e):
                continue
            s, t = e.start_ns(), e.start_ns() + e.duration_ns()
            s, t = max(s, a), min(t, b)
            if t > s:
                out.append((s, t, e.name()))
        out.sort()
        return out

    @cached_property
    def _busy(self) -> list[tuple[int, int]]:
        merged: list[list[int]] = []
        for s, t, _ in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return [(s, t) for s, t in merged]

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self._busy) / 1e9

    def device_s(self, match) -> float:
        """Summed device seconds of activities whose name ``match`` accepts."""
        return sum(t - s for s, t, n in self.device if match(n)) / 1e9

    def top_ops(self, k: int = 10) -> list[list]:
        by: dict[str, int] = {}
        for s, t, n in self.device:
            by[n] = by.get(n, 0) + (t - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:160], v / 1e9] for n, v in top]

    @cached_property
    def _host(self):
        """Host ranges and ops (not runtime calls), sorted by start."""
        from torch.autograd import DeviceType

        hs = []
        for e in self._events:
            if e.device_type() == DeviceType.CPU and e.name() != WINDOW and not e.name().startswith("cuda"):
                hs.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        hs.sort()
        return hs

    def idle_gaps(self, k: int = 10) -> list[list]:
        """Idle seconds inside the window by what the host was doing at each
        gap's middle (the latest started host range or op that had not
        ended), the ``k`` largest."""
        a, b = self.window
        edges = [a] + [x for iv in self._busy for x in iv] + [b]
        gaps = sorted(((s + t) // 2, t - s) for s, t in zip(edges[0::2], edges[1::2]) if t > s)
        hs = self._host
        active: list = []  # max-heap by start of (-start, end, name)
        by: dict[str, int] = {}
        i = 0
        for mid, length in gaps:
            while i < len(hs) and hs[i][0] <= mid:
                heapq.heappush(active, (-hs[i][0], hs[i][1], hs[i][2]))
                i += 1
            while active and active[0][1] <= mid:
                heapq.heappop(active)
            name = active[0][2] if active else "host idle"
            by[name] = by.get(name, 0) + length
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:160], v / 1e9] for n, v in top]

    def span_ms(self, spans: tuple[str, ...]) -> dict[str, float]:
        """Device ms inside the window by the one of ``spans`` around the op
        that launched each kernel, else ``backward`` where that op ran
        inside autograd's engine, else ``other``."""
        if spans in self._spans:
            return self._spans[spans]
        from torch.autograd import DeviceType

        a, b = self.window
        ops, ranges = {}, {}
        for e in self._events:
            if e.device_type() != DeviceType.CPU:
                continue
            name, t0 = e.name(), e.start_ns()
            ops[e.correlation_id()] = (e.start_thread_id(), t0)
            if name in spans or name.startswith(_ENGINE):
                key = name if name in spans else "backward"
                ranges.setdefault(e.start_thread_id(), []).append((t0, t0 + e.duration_ns(), key))
        for rs in ranges.values():
            rs.sort()
        by: dict[str, float] = {}
        for e in self._events:
            if e.device_type() != DeviceType.CUDA or _annotation(e):
                continue
            s, t = max(e.start_ns(), a), min(e.start_ns() + e.duration_ns(), b)
            if t <= s:
                continue
            op = ops.get(e.linked_correlation_id())
            span = "other"
            if op is not None:
                span = _innermost(ranges.get(op[0], []), op[1]) or "other"
            by[span] = by.get(span, 0.0) + (t - s) / 1e6
        self._spans[spans] = by
        return by


def _innermost(rs: list, t: int) -> str | None:
    """Of one thread's (start, end, key) ranges, sorted by start, the key
    of the latest started one that holds ``t`` (the spans do not nest)."""
    i = bisect.bisect_right(rs, (t, float("inf"), "")) - 1
    for j in range(i, max(-1, i - 64), -1):
        if rs[j][1] > t:
            return rs[j][2]
    return None
