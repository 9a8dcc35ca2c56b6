"""FFT-convolution helpers for image formation (NHWC, torch.fft).

Port of ``ppvision_tpu/optics/fourier.py``.  The JAX package keeps
split-complex (re, im) pairs because its TPU has no complex dtype; the
card has one, so these helpers use complex64 ``torch.fft`` directly and
route the batched circular conv to the CUDA kernel of
:mod:`ppvision_tpu_torch.ops.fftconv`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.fftconv import fftconv_circular

__all__ = ["fft_conv2d_circular", "psf2otf_split", "fft_conv2d_linear"]


def fft_conv2d_circular(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Circular FFT convolution over the (H, W) axes of an NHWC image
    (reference ``conv2D``, Face-DeId/Camera/Utils.py:7-12).  ``kernel``
    is (H, W, C), already rolled so its center sits at the (0, 0)
    corner.  The OTF is computed with ``torch.fft`` (it sits outside the
    fused kernel in the JAX package too); the per-image transform pair
    is kernel 1 on CUDA."""
    if img.ndim == 4 and kernel.ndim == 3:
        otf = torch.fft.fft2(kernel, dim=(0, 1))
        return fftconv_circular(img, otf.real.contiguous(), otf.imag.contiguous())
    spec = torch.fft.fft2(img, dim=(-3, -2)) * torch.fft.fft2(kernel, dim=(-3, -2))
    return torch.fft.ifft2(spec, dim=(-3, -2)).real


def psf2otf_split(psf: torch.Tensor, output_hw: tuple[int, int]) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero-pad a centered (H, W, C) PSF to ``output_hw`` and DFT it,
    with the reference's top-left-favouring pad split for even pads
    (Image_Caption/Camera/Utils.py:127-158).  Returns (re, im)."""
    fh, fw, _ = psf.shape
    oh, ow = output_hw
    if oh != fh or ow != fw:
        pad_h = oh - fh
        pad_w = ow - fw
        if pad_h % 2 != 0:
            top, bottom = pad_h // 2 + 1, pad_h // 2
        else:
            top, bottom = pad_h // 2 + 1, pad_h // 2 - 1
        if pad_w % 2 != 0:
            left, right = pad_w // 2 + 1, pad_w // 2
        else:
            left, right = pad_w // 2 + 1, pad_w // 2 - 1
        psf = F.pad(psf, (0, 0, left, right, top, bottom))
    psf = torch.fft.ifftshift(psf, dim=(0, 1))
    otf = torch.fft.fft2(psf, dim=(0, 1))
    return otf.real, otf.imag


def fft_conv2d_linear(img: torch.Tensor, psf: torch.Tensor) -> torch.Tensor:
    """Linear (zero-padded) FFT convolution of an NHWC image with a
    centered PSF (reference ``img_psf_conv(circular=False)``,
    Image_Caption/Camera/Utils.py:251-297), with its one-pixel crop and
    nearest-resize quirk."""
    b, h, w, c = img.shape
    pad_h, pad_w = h // 2, w // 2
    padded = F.pad(img, (0, 0, pad_w, pad_w, pad_h, pad_h))
    otf_r, otf_i = psf2otf_split(psf, (2 * h, 2 * w))
    spec = torch.fft.fft2(padded, dim=(1, 2)) * torch.complex(otf_r, otf_i)[None]
    z = torch.fft.ifft2(spec, dim=(1, 2))
    # The reference takes abs of the complex result; the floor keeps the
    # sqrt gradient finite where the output is exactly zero.
    out = torch.sqrt(z.real * z.real + z.imag * z.imag + 1e-24)
    out = out[:, pad_h + 1 : 2 * h - pad_h, pad_w + 1 : 2 * w - pad_w, :]
    row_idx = torch.clamp((torch.arange(h) * (h - 1)) // h, 0, h - 2).to(img.device)
    col_idx = torch.clamp((torch.arange(w) * (w - 1)) // w, 0, w - 2).to(img.device)
    return out[:, row_idx][:, :, col_idx]
