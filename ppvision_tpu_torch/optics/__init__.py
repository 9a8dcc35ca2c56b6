"""Learned optics: Zernike basis, FFT convolution, the Face-DeId camera
and the captioner's Fresnel lens."""

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
from .lens import LensSpec, OpticsZernike, lens_apply, lens_psf, make_lens_constants

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
    "LensSpec",
    "OpticsZernike",
    "lens_apply",
    "lens_psf",
    "make_lens_constants",
]
