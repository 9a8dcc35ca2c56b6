"""Int8 post-training-quantized convolutions: the opt-in lossy decode.

Port of ``ppvision_tpu/ops/quant.py`` (``ModelConfig.quant_decode``),
the standard dynamic quantization:

- **weights**: symmetric per output channel, from the f32 master
  (``scale = max(amax, 1e-12) / 127``, ``clip(round(w / scale), -127,
  127)``; ``torch.round`` rounds half to even as ``jnp.round`` does);
- **activations**: the compute-dtype input upcast to f32, one abs-max
  scale per sample;
- **accumulation**: int32, rescaled as ``y32.float() * (sx * sk)`` and
  cast to the input dtype; the caller adds the bias in that dtype.

This is not exact math: the mode is opt-in, and the modules' state_dict
is the exact one's (a compute variant, not a checkpoint format).

The int8 products are no Pallas kernel in the JAX package
(``lax.conv_general_dilated`` and ``lax.conv_transpose`` with int32
accumulation), so on CUDA they are plain int8 matrix products,
``torch._int_mm`` (int8 x int8 -> int32 on the tensor cores through
cuBLASLt): a 3x3 conv is the sum over its 9 taps of ``[M, C] @ [C, O]``
products over shifted windows of the zero-padded NHWC input (M = B·H·W
rows; no 9x im2col buffer), and the nearest-up2x conv is four output
phases of 4 such products (:func:`int8_up2x_acc_mm`).  ``_int_mm`` takes
M > 16 and K, N multiples of 8 on CUDA; a shape outside that raises.
Integer sums are exact, so that route equals the plain version bit for
bit.  The plain version runs the same integers through an f64 conv
(every partial sum is an integer below 2^53, so it is exact too); the
CPU path takes it, and the tests hold the ``_int_mm`` route to it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .fusedconv import up2x_kernel

__all__ = [
    "int8_conv",
    "int8_conv3x3_nearest_up2x",
    "int8_conv_acc",
    "int8_conv_acc_mm",
    "int8_conv_acc_ref",
    "int8_up2x_acc",
    "int8_up2x_acc_mm",
    "int8_up2x_acc_ref",
    "quantize_dynamic",
    "quantize_up2x_weight",
    "quantize_weight_per_oc",
]


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-12) / 127`` as a true division: CUDA divides by a
    Python scalar as a product with its reciprocal, which can differ from
    the quotient in the last bit, so 127 goes in as a tensor on amax's
    device."""
    return torch.clamp_min(amax, 1e-12) / torch.full((), 127.0, device=amax.device)


def quantize_weight_per_oc(kernel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of an HWIO kernel:
    ``(kernel_q int8, scale f32[O])`` with ``kernel ~= kernel_q * scale``."""
    k = kernel.float()
    scale = _scale(k.abs().amax(dim=(0, 1, 2)))
    kq = torch.clamp(torch.round(k / scale), -127, 127)
    return kq.to(torch.int8), scale


def quantize_up2x_weight(kernel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The (4, 4, I, O) kernel of nearest-up2x -> conv3x3, summed in f32
    from the (3, 3, I, O) HWIO master as ``ops/fusedconv.py`` sums it,
    quantized once per output channel over all of it."""
    return quantize_weight_per_oc(up2x_kernel(kernel.float().permute(3, 2, 0, 1)))


def quantize_dynamic(x: torch.Tensor, per_sample: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric dynamic int8 of an NHWC batch: ``(x_q int8, scale)``
    with ``x ~= x_q * scale``; the scale is (B, 1, 1, 1) f32, one a
    sample (a 0-d tensor with ``per_sample=False``)."""
    xf = x.float()
    amax = xf.abs().amax(dim=tuple(range(1, x.ndim)), keepdim=True) if per_sample else xf.abs().amax()
    scale = _scale(amax)
    xq = torch.clamp(torch.round(xf / scale), -127, 127)
    return xq.to(torch.int8), scale


def _rescale(y32: torch.Tensor, sx: torch.Tensor, sk: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (y32.float() * (sx * sk)).to(dtype)


def _int_mm_shape(m: int, k: int, n: int) -> None:
    if m <= 16 or k % 8 or n % 8:
        raise ValueError(f"torch._int_mm on CUDA takes M > 16 and K, N multiples of 8; got M={m}, K={k}, N={n}")


def _tap(xp: torch.Tensor, dy: int, dx: int, h: int, w: int) -> torch.Tensor:
    """The (B·H·W, C) rows of the padded input's window at (dy, dx)."""
    return xp[:, dy : dy + h, dx : dx + w, :].reshape(-1, xp.shape[-1])


def int8_conv_acc_mm(xq: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """int32 stride-1 SAME conv of NHWC int8 ``xq`` with an HWIO int8
    ``kq`` (odd kh, kw) as the sum over taps of ``torch._int_mm`` products:
    A is a row-major (M, C) copy of the tap's window, B the tap's (C, O)
    weight as the transpose of an (O, C) row-major copy (the "TN" layout
    cuBLASLt's int8 GEMM takes)."""
    b, h, w, c = xq.shape
    kh, kw, _, o = kq.shape
    _int_mm_shape(b * h * w, c, o)
    xp = F.pad(xq, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    wt = kq.reshape(kh * kw, c, o).transpose(1, 2).contiguous()
    acc = None
    for i in range(kh):
        for j in range(kw):
            p = torch._int_mm(_tap(xp, i, j, h, w), wt[i * kw + j].t())
            acc = p if acc is None else acc.add_(p)
    return acc.reshape(b, h, w, o)


def int8_up2x_acc_mm(xq: torch.Tensor, k4q: torch.Tensor) -> torch.Tensor:
    """int32 ``lax.conv_transpose(xq, K4, (2, 2), ((2, 2), (2, 2)))`` (no
    kernel flip) of NHWC int8 ``xq`` with the (4, 4, I, O) int8 ``k4q``,
    in four output phases: output row 2m + a takes input rows
    m - 1 + a + t with K4 rows a + 2t for t in {0, 1}, and the same for
    columns, so each phase (a, b) is 4 ``_int_mm`` products over windows
    of the input padded by one, summed in int32."""
    b, h, w, c = xq.shape
    o = k4q.shape[-1]
    _int_mm_shape(b * h * w, c, o)
    xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
    wt = k4q.permute(0, 1, 3, 2).contiguous()  # (4, 4, O, C)
    out = torch.empty((b, 2 * h, 2 * w, o), dtype=torch.int32, device=xq.device)
    for a in (0, 1):
        for e in (0, 1):
            acc = None
            for t in (0, 1):
                for u in (0, 1):
                    p = torch._int_mm(_tap(xp, a + t, e + u, h, w), wt[a + 2 * t, e + 2 * u].t())
                    acc = p if acc is None else acc.add_(p)
            out[:, a::2, e::2, :] = acc.reshape(b, h, w, o)
    return out


def int8_conv_acc_ref(xq: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`int8_conv_acc_mm`: the same integers
    through an f64 conv, exact, cast to int32."""
    kh, kw = kq.shape[:2]
    y = F.conv2d(xq.permute(0, 3, 1, 2).double(), kq.permute(3, 2, 0, 1).double(), padding=(kh // 2, kw // 2))
    return y.permute(0, 2, 3, 1).to(torch.int32)


def int8_up2x_acc_ref(xq: torch.Tensor, k4q: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`int8_up2x_acc_mm`: an f64
    ``conv_transpose2d`` with K4 flipped and padding 1, which is the
    unflipped ``lax.conv_transpose`` with padding 2 (``ops/fusedconv.py``)."""
    k = k4q.flip(0, 1).permute(2, 3, 0, 1).double()  # (I, O, 4, 4)
    y = F.conv_transpose2d(xq.permute(0, 3, 1, 2).double(), k, stride=2, padding=1)
    return y.permute(0, 2, 3, 1).to(torch.int32)


def int8_conv_acc(xq: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """int32 accumulators of the int8 conv: the ``_int_mm`` route on
    CUDA (counted in ``launches``), the plain version on the CPU."""
    if xq.device.type == "cpu":
        return int8_conv_acc_ref(xq, kq)
    int8_conv_acc.launches += 1
    return int8_conv_acc_mm(xq, kq)


def int8_up2x_acc(xq: torch.Tensor, k4q: torch.Tensor) -> torch.Tensor:
    """int32 accumulators of the int8 nearest-up2x conv: the ``_int_mm``
    route on CUDA (counted in ``launches``), the plain version on the CPU."""
    if xq.device.type == "cpu":
        return int8_up2x_acc_ref(xq, k4q)
    int8_up2x_acc.launches += 1
    return int8_up2x_acc_mm(xq, k4q)


int8_conv_acc.launches = 0
int8_up2x_acc.launches = 0


def int8_conv(x: torch.Tensor, kernel: torch.Tensor, weight_q=None) -> torch.Tensor:
    """Stride-1 SAME ``conv(x, kernel)`` in int8: ``x`` (B, H, W, I) in
    the compute dtype, ``kernel`` (kh, kw, I, O) f32 master, or its
    ``quantize_weight_per_oc`` pair as ``weight_q`` where the caller
    keeps one.  Output in ``x.dtype``, no bias."""
    xq, sx = quantize_dynamic(x)
    kq, sk = weight_q if weight_q is not None else quantize_weight_per_oc(kernel)
    return _rescale(int8_conv_acc(xq, kq), sx, sk, x.dtype)


def int8_conv3x3_nearest_up2x(x: torch.Tensor, kernel: torch.Tensor, weight_q=None) -> torch.Tensor:
    """Int8 ``conv3x3(SAME)(nearest_up2x(x))``: the 4x4 kernel is summed
    in f32 from the (3, 3, I, O) master and then quantized
    (``quantize_up2x_weight``, or its pair as ``weight_q``), so the only
    approximation is the int8 rounding, applied once."""
    xq, sx = quantize_dynamic(x)
    k4q, sk = weight_q if weight_q is not None else quantize_up2x_weight(kernel)
    return _rescale(int8_up2x_acc(xq, k4q), sx, sk, x.dtype)
