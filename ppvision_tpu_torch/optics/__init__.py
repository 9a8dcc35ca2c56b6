"""Learned optics: Zernike basis, FFT convolution, the Face-DeId camera."""

from .camera import (
    Camera,
    CameraConstants,
    CameraSpec,
    PsfResult,
    camera_apply,
    compute_psf,
    make_camera_constants,
)
from .fourier import fft_conv2d_circular, fft_conv2d_linear, psf2otf_split

__all__ = [
    "Camera",
    "CameraConstants",
    "CameraSpec",
    "PsfResult",
    "camera_apply",
    "compute_psf",
    "make_camera_constants",
    "fft_conv2d_circular",
    "fft_conv2d_linear",
    "psf2otf_split",
]
