"""A first-order backward by replay of the plain version, which the fftconv
and denseblock Functions share (their backward need not be differentiable)."""

from __future__ import annotations

import torch

__all__ = ["plain_vjp"]


def plain_vjp(plain, inputs, needs, grads) -> tuple:
    """The VJP of ``plain(*inputs)`` at the output cotangents ``grads``,
    first order: the plain version is run again on detached inputs and
    differentiated (the forward of the JAX package's VJP is dead code;
    here it is recomputed).  None for each input that ``needs`` leaves
    out."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(bool(n)) if t is not None else None for t, n in zip(inputs, needs)]
        out = plain(*ins)
        wrt = [t for t in ins if t is not None and t.requires_grad]
        got = iter(torch.autograd.grad(out, wrt, grads, allow_unused=True))
    return tuple(next(got) if t is not None and t.requires_grad else None for t in ins)
