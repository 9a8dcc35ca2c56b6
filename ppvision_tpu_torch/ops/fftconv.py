"""Circular FFT convolution with a per-channel OTF: kernel 1 of the port.

``fftconv_circular(img, otf_re, otf_im)`` computes
``real(IFFT2(FFT2(img) * OTF))`` over the (H, W) axes of an NHWC f32
batch.  On a CUDA tensor it runs ``csrc/fftconv.cu`` (radix-2 FFTs in
shared memory in three CUDA launches: forward rows, columns with the OTF
product and the inverse columns, inverse rows; it replaces the Pallas
kernel ``ppvision_tpu/ops/fftconv.py::_fftconv_kernel``); on a CPU
tensor it runs the plain ``torch.fft`` version, which is also the
kernel's oracle on the card.  ``fftconv_circular.launches`` counts
calls: one per call, whatever the number of CUDA launches in it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["fftconv_circular", "fftconv_circular_ref", "fftconv_supported"]

_SIGS = {
    "fftconv_circular": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}
_TWIDDLES: dict[tuple[int, str], torch.Tensor] = {}


def fftconv_circular_ref(img: torch.Tensor, otf_re: torch.Tensor, otf_im: torch.Tensor) -> torch.Tensor:
    """Plain version: torch.fft over (H, W), multiply, real inverse."""
    otf = torch.complex(otf_re, otf_im)
    spec = torch.fft.fft2(img, dim=(-3, -2)) * otf
    return torch.fft.ifft2(spec, dim=(-3, -2)).real


def fftconv_supported(img_shape, otf_shape) -> bool:
    """Shapes the CUDA kernel takes: square power-of-two planes from 4
    to 1024 pixels and an (n, n, C) OTF."""
    if len(img_shape) != 4:
        return False
    b, h, w, c = img_shape
    return h == w and 4 <= h <= 1024 and h & (h - 1) == 0 and tuple(otf_shape) == (h, w, c)


def _twiddles(n: int, device: torch.device) -> torch.Tensor:
    """exp(-2 pi i k / n), k < n/2, built in f64 and rounded to f32, laid
    out per radix-2 stage: entry s + j is the twiddle of butterfly j of
    the stage of span s, exp(-2 pi i j / (2 s)) = entry j n / (2 s) of the
    table (entry 0 is unused)."""
    key = (n, str(device))
    tw = _TWIDDLES.get(key)
    if tw is None:
        z = np.exp(-2j * np.pi * np.arange(n // 2, dtype=np.float64) / n)
        spans = [1 << k for k in range(n.bit_length() - 1)]
        z = np.concatenate([[1.0], *(z[np.arange(s) * (n // (2 * s))] for s in spans)])
        tw = torch.from_numpy(np.stack([z.real, z.imag], -1).astype(np.float32)).to(device)
        _TWIDDLES[key] = tw
    return tw


def fftconv_circular(img: torch.Tensor, otf_re: torch.Tensor, otf_im: torch.Tensor) -> torch.Tensor:
    """Circular conv of an NHWC f32 batch (B, n, n, C) with an (n, n, C)
    OTF given as real and imaginary f32 parts.  CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if img.device.type != "cuda":
        return fftconv_circular_ref(img, otf_re, otf_im)
    if not fftconv_supported(img.shape, otf_re.shape) or otf_im.shape != otf_re.shape:
        raise ValueError(
            f"fftconv kernel takes (B, n, n, C) images with power-of-two n "
            f"and an (n, n, C) OTF; got {tuple(img.shape)} and {tuple(otf_re.shape)}"
        )
    for t in (img, otf_re, otf_im):
        if t.dtype != torch.float32 or t.device != img.device:
            raise ValueError("fftconv kernel takes float32 tensors on one CUDA device")
    img = img.contiguous()
    otf_re = otf_re.contiguous()
    otf_im = otf_im.contiguous()
    b, n, _, c = img.shape
    lib = _build.load("fftconv", _SIGS)
    out = torch.empty_like(img)
    # The B C planes of the spectrum, then C planes of the permuted OTF.
    spec = torch.empty((b * c + c, n, n, 2), dtype=torch.float32, device=img.device)
    tw = _twiddles(n, img.device)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    err = lib.fftconv_circular(
        img.data_ptr(), otf_re.data_ptr(), otf_im.data_ptr(), tw.data_ptr(), out.data_ptr(),
        spec.data_ptr(), b, n, c, stream,
    )
    _build.check(lib, err, "fftconv_circular")
    fftconv_circular.launches += 1
    return out


fftconv_circular.launches = 0
