"""A record of the work the reference does, for the work counters.

While a :func:`recording` block is open, the reference's kernel-shaped
operations append one entry each: ``(kind, shape)``, the shape that the
kernel of that kind would be handed (NHWC, plus the output features of
a conv).  Outside such a block nothing is recorded.
"""

from __future__ import annotations

import contextlib

_TAPE: list | None = None


@contextlib.contextmanager
def recording():
    """Collect the entries of the reference's calls made inside."""
    global _TAPE
    prev, _TAPE = _TAPE, []
    try:
        yield _TAPE
    finally:
        _TAPE = prev


def note(kind: str, *shape: int) -> None:
    if _TAPE is not None:
        _TAPE.append((kind, tuple(int(s) for s in shape)))


def counting() -> bool:
    """True inside a recording: the FLOP count runs on ``meta`` tensors."""
    return _TAPE is not None
