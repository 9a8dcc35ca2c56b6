"""Face-DeId learned-optics camera (two-step scaled-FFT propagation).

Port of ``ppvision_tpu/optics/camera.py`` (reference
``Face-DeId/Camera/Optics.py:9-129``): a trainable Zernike phase mask
on the lens aperture, two-step scaled-FFT propagation from the lens
plane to the sensor plane, PSF = field intensity, circular FFT
convolution with the image, per-image max normalization.

Every static phase (lens, focus and scaled-FFT chirps, aperture) is
folded on the host in float64, where the chirps' 1e5-radian phases keep
their precision, and stored as complex64 tensors; only the small
trainable Zernike phase is computed on the device.  The PSF uses
``torch.fft`` in complex64; the image convolution is kernel 1
(:mod:`ppvision_tpu_torch.ops.fftconv`) on CUDA.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .fourier import fft_conv2d_circular
from .zernike import zernike_volume

__all__ = [
    "CameraSpec",
    "CameraConstants",
    "Camera",
    "PsfResult",
    "make_camera_constants",
    "compute_psf",
    "camera_apply",
]


def refractive_index_contrast(wavelength_um: np.ndarray) -> np.ndarray:
    """|n_lens - n_air| for fused silica vs air (Sellmeier + Ciddor), as
    the reference's ``deta`` (Face-DeId/Camera/Utils.py:33-40); microns,
    float64."""
    lb2 = wavelength_um**2
    n_lens = np.sqrt(
        1.0
        + 0.6961663 * lb2 / (lb2 - 0.0684043**2)
        + 0.4079426 * lb2 / (lb2 - 0.1162414**2)
        + 0.8974794 * lb2 / (lb2 - 9.896161**2)
    )
    inv_lb2 = wavelength_um**-2.0
    n_air = 1.0 + 0.05792105 / (238.0185 - inv_lb2) + 0.00167917 / (57.362 - inv_lb2)
    return np.abs(n_lens - n_air)


@dataclasses.dataclass(frozen=True)
class CameraSpec:
    """Static geometry of the privacy camera (reference
    Face-DeId/Camera/Optics.py:10-56)."""

    n: int = 256
    zernike_terms: int = 300
    n_frozen: int = 3
    aperture_radius: float = 2.0e-3
    zi: float = 50e-3
    z0: float = 5.0
    pixel_pitch: float = 3.713103e-6
    scene_depth: float = 0.75
    wavelengths: tuple[float, ...] = (640e-9, 550e-9, 440e-9)
    mask_radius_px: int = 32
    # The reference propagates with torch.fft.fftn/ifftn without a dim
    # argument (Optics.py:101-105), which also runs a length-3 DFT across
    # the wavelength axis; its checkpoints were trained with that
    # coupling, so it stays on by default.
    couple_wavelengths: bool = True

    @property
    def lens_extent(self) -> float:
        return 4.0 * self.aperture_radius

    @property
    def sensor_extent(self) -> float:
        return self.pixel_pitch * self.n


class CameraConstants(NamedTuple):
    """Device-resident static tensors."""

    zernike_basis: torch.Tensor  # (T, N*N) f32, height-map units (1e-6 m)
    phase_scale: torch.Tensor  # (C, 1, 1) f32: k * f_lambda per wavelength
    chirp_pre: torch.Tensor  # (C, N, N) complex64: aperture * lens * focus * pre-chirp
    chirp_freq: torch.Tensor  # (C, N, N) complex64: scaled-FFT frequency chirp
    chirp_post: torch.Tensor  # (C, N, N) complex64: post-chirp * amplitude scale
    rho_mask: torch.Tensor  # (N, N) f32: 1 outside mask_radius_px on the sensor
    couple_wavelengths: bool = True


class PsfResult(NamedTuple):
    psf: torch.Tensor  # (N, N, C) f32, sums to 1 over all entries
    loss_rad: torch.Tensor  # scalar: Frobenius norm of PSF energy outside radius
    centering_loss: torch.Tensor  # scalar: half-period shift symmetry penalty


def make_camera_constants(spec: CameraSpec, device: torch.device | str = "cpu") -> CameraConstants:
    """Precompute every static tensor of the optical model (host, f64)."""
    n = spec.n
    lam = np.asarray(spec.wavelengths, dtype=np.float64)[:, None, None]  # (C,1,1)
    f = 1.0 / (1.0 / spec.zi + 1.0 / spec.z0)
    r_surf = f * refractive_index_contrast(np.float64(550e-9 * 1e6))
    f_lam = r_surf / refractive_index_contrast(lam * 1e6)
    k = 2.0 * np.pi / lam

    l_len = spec.lens_extent
    l_sen = spec.sensor_extent
    du = l_len / n
    dx2 = l_sen / n

    u = np.arange(-l_len / 2.0, l_len / 2.0, du, dtype=np.float64)[:n]
    xx, yy = np.meshgrid(u, u, indexing="ij")
    xy = xx * xx + yy * yy
    aperture = (np.sqrt(xy) <= spec.aperture_radius).astype(np.float64)

    fx = np.arange(-1.0 / (2.0 * du), 1.0 / (2.0 * du), 1.0 / l_len, dtype=np.float64)[:n]
    fx = np.roll(fx, -(n // 2))  # corner-origin frequency order
    fxx, fyy = np.meshgrid(fx, fx, indexing="ij")
    ff = fxx * fxx + fyy * fyy

    x2 = np.arange(-l_sen / 2.0, l_sen / 2.0, dx2, dtype=np.float64)[:n]
    sx, sy = np.meshgrid(x2, x2, indexing="ij")
    xy2 = sx * sx + sy * sy
    rho_mask = (np.sqrt(xy2) > spec.pixel_pitch * spec.mask_radius_px).astype(np.float32)

    phase_pre = (
        -(k / (2.0 * f_lam)) * xy
        + (k / (2.0 * spec.scene_depth)) * xy
        + (np.pi / (lam * spec.zi * l_len)) * (l_len - l_sen) * xy
    )
    chirp_pre = aperture * np.exp(1j * phase_pre)
    chirp_freq = np.exp(-1j * (np.pi * lam * spec.zi * l_len / l_sen) * ff)
    amp = (l_sen / l_len) * (du * du) / (dx2 * dx2)
    chirp_post = amp * np.exp(-1j * (np.pi / (lam * spec.zi * l_sen)) * (l_len - l_sen) * xy2)

    basis = zernike_volume(n, spec.zernike_terms).reshape(spec.zernike_terms, n * n)

    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a).astype(dtype)).to(device)

    return CameraConstants(
        zernike_basis=dev(basis, np.float32),
        phase_scale=dev(k * f_lam, np.float32),
        chirp_pre=dev(chirp_pre, np.complex64),
        chirp_freq=dev(chirp_freq, np.complex64),
        chirp_post=dev(chirp_post, np.complex64),
        rho_mask=dev(rho_mask, np.float32),
        couple_wavelengths=spec.couple_wavelengths,
    )


class Camera(nn.Module):
    """Trainable Zernike coefficients under the reference's state_dict
    names: ``Zer_train`` (T - n_frozen, 1, 1) and ``Zer_no_train``
    (n_frozen, 1, 1), the frozen head held out of the gradient.

    Init matches the reference (Optics.py:59-62): U[0, 1)/100 per
    coefficient with the first ``n_frozen`` zeroed, drawn from ``seed``.
    """

    def __init__(self, spec: CameraSpec, seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        inits = torch.rand(spec.zernike_terms, generator=g) / 100.0
        self.Zer_train = nn.Parameter(inits[spec.n_frozen :].reshape(-1, 1, 1).clone())
        self.Zer_no_train = nn.Parameter(
            torch.zeros(spec.n_frozen, 1, 1), requires_grad=False
        )

    def full_coeffs(self) -> torch.Tensor:
        """(T,) coefficients, frozen head first."""
        return torch.cat([self.Zer_no_train.detach().reshape(-1), self.Zer_train.reshape(-1)])


def compute_psf(camera: Camera, consts: CameraConstants) -> PsfResult:
    """Trainable phase -> PSF, plus the PSF regularizer losses."""
    n = consts.rho_mask.shape[-1]
    coeffs = camera.full_coeffs()
    height_map = (coeffs[None, :] @ consts.zernike_basis).reshape(n, n)
    phase = consts.phase_scale * height_map[None]  # (C, N, N)
    field = consts.chirp_pre * torch.complex(torch.cos(phase), torch.sin(phase))
    field = torch.fft.fftshift(field, dim=(-2, -1))
    field = torch.fft.fft2(field, dim=(1, 2))
    if consts.couple_wavelengths:
        field = torch.fft.fft(field, dim=0)
    field = field * consts.chirp_freq
    if consts.couple_wavelengths:
        field = torch.fft.ifft(field, dim=0)
    field = torch.fft.ifft2(field, dim=(1, 2))
    field = torch.fft.ifftshift(field, dim=(-2, -1))
    field = field * consts.chirp_post

    psf = field.real * field.real + field.imag * field.imag  # (C, N, N)
    psf = psf / torch.sum(psf)  # joint normalization over wavelengths
    loss_rad = torch.linalg.vector_norm(consts.rho_mask[None] * psf)
    centering = torch.mean(torch.square(psf - torch.roll(psf, n // 2, dims=-2)))
    centering = centering + torch.mean(torch.square(psf - torch.roll(psf, n // 2, dims=-1)))
    return PsfResult(psf=psf.permute(1, 2, 0), loss_rad=loss_rad, centering_loss=centering)


def camera_apply(
    camera: Camera, consts: CameraConstants, img: torch.Tensor
) -> tuple[torch.Tensor, PsfResult]:
    """Privacy-preserved sensor image of an NHWC batch in [0, 1]:
    PSF -> roll its center to the corner -> circular FFT conv ->
    per-image max normalization (reference Optics.py:122-129)."""
    res = compute_psf(camera, consts)
    n = res.psf.shape[0]
    kernel = torch.roll(res.psf, shifts=(-(n // 2), -(n // 2)), dims=(0, 1))
    sensor = fft_conv2d_circular(img, kernel)
    peak = torch.amax(sensor, dim=(1, 2, 3), keepdim=True)
    return sensor / peak, res
