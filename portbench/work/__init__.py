"""Work counters: operations and bytes from shapes, against the H100's
published peaks (NVIDIA's data sheet, SXM part, dense rates, at the full
700 W power limit).

A kernel's least time is the larger of its bytes over the HBM rate and
its operations over the peak rate of their type.  Each input byte is
counted read once and each output byte written once.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12  # H100 SXM HBM3
BF16_FLOP_S = 989e12  # dense bf16 tensor-core peak
F32_FLOP_S = 67e12  # f32 outside the tensor cores

__all__ = ["BF16_FLOP_S", "F32_FLOP_S", "HBM_BYTES_S", "bound_s", "conv3x3_bound_s", "instats_bound_s",
           "denseblock_bound_s", "kernel_bound_s"]


def bound_s(bytes_moved: float, ops: float, peak: float) -> float:
    """Least seconds on the card for this many bytes and operations."""
    return max(bytes_moved / HBM_BYTES_S, ops / peak)


def conv3x3_bound_s(b: int, h: int, w: int, c: int, k: int, elem: int = 2) -> float:
    """A SAME stride-1 3x3 conv, (B, H, W, C) -> (B, H, W, K), bf16: the
    input and the output once, the (3, 3, C, K) weights once, 2 x MACs."""
    return bound_s(elem * (b * h * w * (c + k) + 9 * c * k), 2 * 9 * b * h * w * c * k, BF16_FLOP_S)


def instats_bound_s(b: int, h: int, w: int, c: int, elem: int = 2) -> float:
    """Per-(image, channel) mean and mean of squares: the input once, two
    f32 outputs, 3 operations an element (f32, outside the tensor cores)."""
    n = b * h * w * c
    return bound_s(elem * n + 2 * 4 * b * c, 3 * n, F32_FLOP_S)


def denseblock_bound_s(b: int, h: int, w: int, f: int, elem: int = 2) -> float:
    """FAN's dense block, F -> F/2 -> F/4 -> F/4 3x3 convs concatenated
    plus the residual: x read once, the output written once, the three
    kernels and the BN pack once, 2 x MACs."""
    macs = b * h * w * 9 * (f * f // 2 + f // 2 * f // 4 + f // 4 * f // 4)
    weights = 9 * (f * f // 2 + f // 2 * f // 4 + f // 4 * f // 4)
    return bound_s(elem * (2 * b * h * w * f + weights) + 4 * 6 * f, 2 * macs, BF16_FLOP_S)


_BOUNDS = {"conv3x3": conv3x3_bound_s, "instats": instats_bound_s, "denseblock": denseblock_bound_s}


def kernel_bound_s(tape: list, kind: str) -> float:
    """Sum of the least times of the taped calls of one kind."""
    fn = _BOUNDS[kind]
    return sum(fn(*shape) for k, shape in tape if k == kind)
