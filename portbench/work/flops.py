"""FLOPs of a reference call, counted on ``meta`` tensors.

``torch.utils.flop_counter.FlopCounterMode`` counts the matrix products
and convolutions (2 x multiply-adds), forward and, where the call runs
one, backward; elementwise work and FFTs are not counted.  The
reference's :mod:`..reference.tape` is recorded in the same pass, so
the kernels' shapes come with it.
"""

from __future__ import annotations

from torch.utils.flop_counter import FlopCounterMode

from ..reference import tape

__all__ = ["count"]


def count(fn, *args, **kwargs) -> tuple[int, list]:
    """(FLOPs, tape) of ``fn(*args, **kwargs)`` run on meta tensors."""
    with tape.recording() as t, FlopCounterMode(display=False) as fc:
        fn(*args, **kwargs)
    return int(fc.get_total_flops()), list(t)
