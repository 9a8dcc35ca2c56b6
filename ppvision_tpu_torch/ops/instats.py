"""Per-(sample, channel) E[x] and E[x^2] over H, W: kernel 3.

``instance_moments(x)`` returns the f32 (B, C) mean and mean of squares
of an NHWC tensor, each sum divided by n = H*W once, as ``jnp.mean``
does.  On CUDA it launches ``csrc/instats.cu``, which replaces the
Pallas kernel ``ppvision_tpu/ops/instats.py::_kernel``; on the CPU it
runs :func:`_moments_ref`.

The kernel is a streaming reduction bound by HBM bandwidth.  Each image
is read whole by one block for each slice of its channels, or, where it
is large, cut into S chunks of whole pixels (:func:`plan_split`, from
the shape alone); a block reads its chunk of its slice with 16-byte
loads, and where S > 1 the last block of each (image, slice) adds the S
partial sums in a fixed order.  So the result's bits depend on the shape
alone: two calls agree bit for bit.  The partial sums and the tickets
live in a scratch buffer the wrapper keeps per device and stream (the
kernel leaves the tickets zeroed); the kernel allocates nothing.

The kernel has no backward, as the Pallas kernel has none: a call that
needs a gradient goes through :class:`MomentsFn`, whose backward is the
plain version's VJP (``ppvision_tpu/ops/instats.py::_make``'s ``bwd``).

``norm_apply(x, mean, m2, eps, slope, ...)`` applies the norm those
moments give, with an affine or the AdaIN modulation, and the leaky
ReLU that follows every norm of the Generator: on CUDA,
for bf16 where no gradient is needed, one pass of the same build unit's
second kernel; everywhere else :func:`norm_apply_ref`, the eager
composite, whose bytes the kernel reproduces.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["MomentsFn", "instance_moments", "moments_vjp", "norm_apply", "norm_apply_ref", "plan_split",
           "_moments_ref"]

_SIGS = {
    "instance_moments": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "norm_apply": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p],
}

SPREAD_BLOCKS = 128  # blocks the channel slices reach where they can: about one an SM
FILL_BLOCKS = 2 * 132  # blocks the pixel chunks aim at: two for each of an H100's 132 SMs
# Bytes a block reads: an (image, slice) of at most MAX_CHUNK is one
# block; a larger image is cut into chunks of at most MAX_CHUNK, none
# under MIN_CHUNK (one round of 16 loads of 16 bytes a thread is 64 KB).
# A channel slice is at least MIN_SLICE bytes a pixel.
MIN_CHUNK = 64 << 10
MAX_CHUNK = 128 << 10
MIN_SLICE = 32

# (device index, stream) -> (partial sums, tickets), grown as needed.
_SCRATCH: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _moments_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: f32 mean and mean of squares over (H, W)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    return xf.mean(dim=(1, 2)), (xf * xf).mean(dim=(1, 2))


def moments_vjp(x: torch.Tensor, gm: torch.Tensor, gm2: torch.Tensor) -> torch.Tensor:
    """The gradient of :func:`_moments_ref` at NHWC ``x`` for the (B, C)
    cotangents of the mean and the mean of squares, in x's dtype:
    (gm + 2 x gm2) / (H W), from differentiable ops."""
    n = x.shape[1] * x.shape[2]
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    dx = gm[:, None, None, :] / n + (2.0 / n) * (gm2[:, None, None, :] * xf)
    return dx.to(x.dtype)


class MomentsFn(torch.autograd.Function):
    """``forward(x)`` computes the two moments (the kernel on CUDA); the
    backward is :func:`moments_vjp` on the saved x.  ``forward`` is the
    function that computes them (the kernel launch, or in tests the
    plain version)."""

    @staticmethod
    def forward(ctx, x, forward):
        ctx.save_for_backward(x)
        return forward(x)

    @staticmethod
    def backward(ctx, gm, gm2):
        (x,) = ctx.saved_tensors
        return moments_vjp(x, gm, gm2), None


@functools.lru_cache(maxsize=256)
def plan_split(b: int, hw: int, c: int, esize: int) -> tuple[int, int, int]:
    """(S, chunk, slices): the kernel cuts each of the ``b`` images of
    ``hw`` pixels into S chunks of ``chunk`` whole pixels (the last may
    be shorter, none is empty) and its ``c`` channels into ``slices``.

    Slices need no combine, so a small image is one chunk: as few
    16-byte-aligned slices of at least MIN_SLICE bytes a pixel as give
    SPREAD_BLOCKS blocks (or as many as there may be), if a slice is then
    at most MAX_CHUNK bytes.  A larger image is not sliced but cut into
    chunks: enough for at most MAX_CHUNK bytes a block and for
    FILL_BLOCKS blocks, but none under MIN_CHUNK bytes."""
    row = c * esize
    per_img = hw * row
    slices = 1
    if row % 16 == 0:
        groups = row // 16
        for d in range(2, groups + 1):
            if b * slices >= SPREAD_BLOCKS:
                break
            if groups % d == 0 and row // d >= MIN_SLICE:
                slices = d
    if per_img // slices <= MAX_CHUNK:
        return 1, hw, slices
    s = max(-(-per_img // MAX_CHUNK), FILL_BLOCKS // b)
    s = max(1, min(s, per_img // MIN_CHUNK, hw))
    chunk = -(-hw // s)
    return -(-hw // chunk), chunk, 1


def _scratch(device: torch.device, stream: int, floats: int, lines: int):
    ws, tickets = _SCRATCH.get((device.index, stream), (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(floats, dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < lines:
        tickets = torch.zeros(lines, dtype=torch.int32, device=device)
    _SCRATCH[device.index, stream] = ws, tickets
    return ws, tickets


def _launch(x: torch.Tensor, splits: int, chunk: int, slices: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel on a contiguous NHWC ``x`` cut ``splits`` x
    ``chunk`` pixels and ``slices`` channel slices."""
    b, h, w, c = x.shape
    esize = x.element_size()
    vec = 16 // esize if (c * esize) % 16 == 0 and x.data_ptr() % 16 == 0 else 1
    out = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ws = tickets = None
    if splits > 1:
        ws, tickets = _scratch(x.device, stream, b * splits * 2 * c, b * slices)
        ws, tickets = ws.data_ptr(), tickets.data_ptr()
    lib = _build.load("instats", _SIGS)
    err = lib.instance_moments(
        x.data_ptr(), out.data_ptr(), ws, tickets, b, h * w, c, esize, vec, chunk, splits, slices, stream
    )
    _build.check(lib, err, "instance_moments")
    instance_moments.launches += 1
    return out.unbind(0)


def instance_moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, mean of squares) over the (H, W) axes of an NHWC tensor,
    f32, shape (B, C) each.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise.  A CUDA tensor that is not
    contiguous is copied first, and ``instance_moments.copies`` counts
    those calls.  Where a gradient is needed the call goes through
    :class:`MomentsFn`."""
    if x.device.type != "cuda":
        return _moments_ref(x)
    if x.ndim != 4 or x.dtype not in (torch.bfloat16, torch.float32) or x.numel() == 0:
        raise ValueError(
            f"instats kernel takes non-empty bf16/f32 NHWC input, got {x.dtype} {tuple(x.shape)}"
        )
    b, h, w, c = x.shape
    if b > 65535:
        raise ValueError(f"instats kernel takes at most 65535 images, got {b}")
    if not x.is_contiguous():
        instance_moments.copies += 1
        x = x.contiguous()
    if torch.is_grad_enabled() and x.requires_grad:
        return MomentsFn.apply(x, _kernel)
    return _kernel(x)


def _kernel(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    b, h, w, c = x.shape
    return _launch(x, *plan_split(b, h * w, c, x.element_size()))


instance_moments.launches = 0
instance_moments.copies = 0


def norm_apply_ref(x, mean, m2, eps: float, slope: float, weight=None, bias=None, style=None):
    """The instance norm of NCHW ``x`` from its (B, C) moments ``mean``
    and ``m2`` (E[x], E[x^2]), in the composite the Generator has always
    run: in f32, ``(x - mean) * rsqrt(max(m2 - mean^2, 0) + eps)``, then
    either ``* weight + bias``, cast to x's dtype, or, with ``style``
    (the AdaIN dense layer's (B, 2C) output, gamma then beta), cast to
    x's dtype and ``(1 + gamma) * y + beta`` in its dtype, cast to x's;
    then the leaky ReLU of ``slope`` (as the op takes it:
    ``models/stargan.py::leaky_relu`` rounds 0.2 to the dtype first).
    The kernel's plain version."""
    if (style is None) == (weight is None) or (weight is None) != (bias is None):
        raise ValueError("norm_apply: give weight and bias, or style")
    mean, m2 = mean[:, :, None, None], m2[:, :, None, None]
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    var = torch.clamp_min(m2 - mean * mean, 0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if style is None:
        y = (y * weight[:, None, None] + bias[:, None, None]).to(x.dtype)
    else:
        gamma, beta = torch.chunk(style, 2, dim=1)
        y = ((1 + gamma[:, :, None, None]) * y.to(x.dtype) + beta[:, :, None, None]).to(x.dtype)
    return F.leaky_relu(y, slope)


def norm_apply_takes(x, weight=None, bias=None, style=None) -> bool:
    """Whether the kernel computes this call: bf16 ``x`` (and style)
    whose pixels are whole 16-byte loads (C * 2 bytes a multiple of 16,
    the NHWC memory 16-byte aligned), where no gradient is needed (grad
    disabled, or nothing among x, the style and the parameters
    requires it).  The device is the caller's test."""
    if x.dtype != torch.bfloat16 or x.ndim != 4 or x.numel() == 0 or (x.shape[1] * 2) % 16:
        return False
    if style is not None and style.dtype != torch.bfloat16:
        return False
    if x.data_ptr() % 16:
        return False
    if torch.is_grad_enabled():
        return not any(t is not None and t.requires_grad for t in (x, weight, bias, style))
    return True


def norm_apply(x, mean, m2, eps: float, slope: float, weight=None, bias=None, style=None):
    """:func:`norm_apply_ref` of NCHW ``x`` (channels_last in the
    Generator): on CUDA, where :func:`norm_apply_takes`, one launch of
    the kernel, which returns its bytes (``norm_apply.launches`` counts
    those calls); every other CUDA call runs the composite and counts in
    ``norm_apply.eager``; CPU tensors run the composite."""
    if x.device.type != "cuda":
        return norm_apply_ref(x, mean, m2, eps, slope, weight, bias, style)
    if not norm_apply_takes(x, weight, bias, style):
        norm_apply.eager += 1
        return norm_apply_ref(x, mean, m2, eps, slope, weight, bias, style)
    xh = x.permute(0, 2, 3, 1).contiguous()
    b, h, w, c = xh.shape
    shapes = {"mean": (mean, (b, c)), "m2": (m2, (b, c)), "weight": (weight, (c,)), "bias": (bias, (c,)),
              "style": (style, (b, 2 * c))}
    bad = [k for k, (t, want) in shapes.items() if t is not None and (t.shape != want or t.device != x.device)]
    if bad or (style is None) == (weight is None) or (weight is None) != (bias is None):
        what = bad or "weight and bias, or style,"
        raise ValueError(f"norm_apply: {what} do not fit x {tuple(x.shape)} on {x.device}")
    out = torch.empty_like(xh)
    args = [xh, out, *(None if t is None else t.float().contiguous() for t in (mean, m2, weight, bias)),
            None if style is None else style.contiguous()]
    ptrs = [None if t is None else t.data_ptr() for t in args]
    lib = _build.load("instats", _SIGS)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.norm_apply(*ptrs, b, h * w, c, eps, slope, stream)
    _build.check(lib, err, "norm_apply")
    norm_apply.launches += 1
    return out.permute(0, 3, 1, 2)


norm_apply.launches = 0
norm_apply.eager = 0
