"""Image-captioning learned-optics camera (Fresnel propagation).

Port of ``ppvision_tpu/optics/lens.py`` (reference ``OpticsZernike``,
``Image_Caption/Camera/Lens.py:11-339``, and its propagation helpers in
``Image_Caption/Camera/Utils.py``).  Physics: a spherical wavefront from
a finite-depth point source passes a trainable Zernike phase plate
(only the defocus coefficient trains; init -22) and a circular
aperture, Fresnel-propagates 25 mm to the sensor through a 1/4-padded
transfer function, the intensity PSF is area-downsampled 896 -> 256 and
per-channel normalized, optionally masked to / penalized on a central
32 px disk, and finally linearly FFT-convolved with the image.

The static phases (spherical wavefront, Fresnel transfer function, both
reaching 1e5 radians) are evaluated on the host in float64 and stored as
complex64 tensors (complex128 for a float64 lens); the propagation is
``torch.fft`` on the (C, M, M) field.  Manufacturing-noise injection
(the reference's ``PhasePlate`` height tolerance,
``Image_Caption/Camera/Utils.py:397-406``) draws from the
``torch.Generator`` passed to :func:`lens_psf`, and is off without one.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..ops.image import resize_nearest
from .fourier import fft_conv2d_linear
from .zernike import zernike_basis, zernike_volume

__all__ = [
    "LensSpec",
    "LensConstants",
    "LensResult",
    "OpticsZernike",
    "make_lens_constants",
    "init_lens_params",
    "lens_coeffs",
    "lens_psf",
    "lens_apply",
]


@dataclasses.dataclass(frozen=True)
class LensSpec:
    """Static geometry; defaults reproduce the reference configuration
    (``Image_Caption/train.py:64-66``: 896^2 wave grid, 256^2 sensor,
    3 um sampling, 25 mm sensor distance, 350 Zernike terms)."""

    wave_res: int = 896
    patch_size: int = 256
    zernike_terms: int = 350
    sensor_distance: float = 25e-3
    sample_interval: float = 3e-6
    wavelengths: tuple[float, ...] = (460e-9, 550e-9, 640e-9)
    refractive_idcs: tuple[float, ...] = (1.499, 1.493, 1.488)
    height_tolerance: float = 2e-8
    depth: float = 0.5  # 1/diopters: reference optics_cfg=1 -> 1/2
    defocus_init: float = -22.0
    mask_radius_px: int = 32

    @property
    def physical_size(self) -> float:
        return self.wave_res * self.sample_interval

    @property
    def pad(self) -> int:
        return self.wave_res // 4


class LensConstants(NamedTuple):
    """Device-resident static tensors (phases precomputed in f64).

    Only the defocus coefficient trains, so the frozen coefficients'
    contribution is folded into ``height_base`` on the host and the
    trainable direction is the single ``defocus_plane``."""

    height_base: torch.Tensor  # (N, N): sum of frozen coeffs x basis
    defocus_plane: torch.Tensor  # (N, N): Noll j=4 basis plane
    phase_scale: torch.Tensor  # (C, 1, 1): wave_nos * (n_lens - 1) per channel
    static_pre: torch.Tensor  # (C, N, N) complex: aperture * spherical wavefront
    fresnel_h: torch.Tensor  # (C, M, M) complex: padded transfer function
    mask_keep: torch.Tensor  # (P, P, 1): 1 inside the central disk


class LensResult(NamedTuple):
    sensor: torch.Tensor  # (B, P, P, C) in [0, 1] (global max-normalized)
    psf: torch.Tensor  # (P, P, C), per-channel sum = 1 (before crop mask)
    coeffs: torch.Tensor  # (T,) full coefficient vector
    psf_loss: torch.Tensor  # scalar central-disk energy penalty (or 0.0)


def _disk_mask(p: int, radius: int) -> np.ndarray:
    """(P, P) central disk: ``cv2.circle`` where cv2 imports (the
    reference's rasterization, ``Lens.py:111-127``), else the exact disk
    r <= radius; the two differ by a ring of edge pixels."""
    try:
        import cv2  # noqa: PLC0415

        m = np.zeros((p, p), dtype=np.float64)
        cv2.circle(img=m, center=[p // 2, p // 2], radius=radius, color=1.0, thickness=-1,
                   lineType=cv2.FILLED)
        return m
    except ImportError:
        yy, xx = np.indices((p, p), dtype=np.float64)
        return (np.hypot(yy - p // 2, xx - p // 2) <= radius).astype(np.float64)


def make_lens_constants(
    spec: LensSpec,
    frozen_coeffs: np.ndarray | None = None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> LensConstants:
    """Build the static tensors on ``device``.

    ``frozen_coeffs`` is the full (T,) coefficient vector whose index 3
    (defocus) is ignored; pass the values of a warm start if they are
    nonzero (they are zero in every shipped config).  ``dtype=float64``
    keeps every folded constant at double precision (complex128 phases);
    ``float32`` rounds them once, to complex64."""
    f64 = dtype == torch.float64
    npdt = np.float64 if f64 else np.float32
    n = spec.wave_res
    c = len(spec.wavelengths)
    lam = np.asarray(spec.wavelengths, dtype=np.float64)[:, None, None]
    wave_nos = 2.0 * np.pi / lam
    delta_n = np.asarray(spec.refractive_idcs, dtype=np.float64)[:, None, None] - 1.0

    # Spherical wavefront from a point at `depth`, on the wave grid
    # (reference Lens.py:191-210; f64 mgrid pixel coordinates).
    x, y = np.mgrid[-n // 2 : n // 2, -n // 2 : n // 2].astype(np.float64)
    xs = x / n * spec.physical_size
    ys = y / n * spec.physical_size
    curvature = np.sqrt(xs**2 + ys**2 + spec.depth**2)[None]
    wavefront = np.exp(1j * wave_nos * curvature)
    # Circular aperture in pixel units: r < max(x) (reference Utils.py:88-97,
    # the max over the pixel grid, n/2 - 1).
    aperture = (np.sqrt(x**2 + y**2) < np.amax(x)).astype(np.float64)[None]
    static_pre = aperture * wavefront

    # Fresnel transfer function on the 1/4-padded grid (reference
    # Utils.py:328-378).
    m = n + 2 * spec.pad
    fx = np.fft.ifftshift(np.mgrid[-m // 2 : m // 2].astype(np.float64) / (spec.sample_interval * m))
    fxx, fyy = np.meshgrid(fx, fx, indexing="ij")
    h = np.exp(1j * (-np.pi * lam * spec.sensor_distance * (fxx**2 + fyy**2)[None]))

    inside = _disk_mask(spec.patch_size, spec.mask_radius_px).astype(npdt)[:, :, None]

    # Zernike planes: defocus is the only trainable direction; the frozen
    # contribution folds into one static plane.
    if frozen_coeffs is None:
        basis4 = zernike_basis(4, n)[3] * 1e-6
        height_base = np.zeros((n, n), dtype=npdt)
        # The f32 mode rounds the plane as the reference's f32 volume
        # does (Lens.py:70) before any further math.
        defocus_plane = basis4 if f64 else basis4.astype(np.float32)
    else:
        frozen = np.asarray(frozen_coeffs, dtype=np.float64).copy()
        t = frozen.shape[0]
        frozen[3] = 0.0
        vol = zernike_basis(t, n) * 1e-6 if f64 else zernike_volume(n, t).astype(np.float64)
        height_base = np.einsum("t,thw->hw", frozen, vol).astype(npdt)
        defocus_plane = vol[3].astype(npdt)

    cdt = np.complex128 if f64 else np.complex64

    def dev(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a).astype(dt)).to(device)

    return LensConstants(
        height_base=dev(height_base, npdt),
        defocus_plane=dev(defocus_plane, npdt),
        phase_scale=dev(wave_nos * delta_n, npdt).reshape(c, 1, 1),
        static_pre=dev(static_pre, cdt),
        fresnel_h=dev(h, cdt),
        mask_keep=dev(inside, npdt),
    )


class OpticsZernike(nn.Module):
    """The lens's Zernike coefficients under the reference's state_dict
    names: ``zernike_coeffs_train`` (the defocus, Noll j=4, shape
    (1, 1, 1)), and the frozen ``zernike_coeffs_no_train`` (j=1-3) and
    ``zernike_coeffs_no_train2`` (j=5..T), held out of the gradient.
    The init is the reference's (Lens.py:80-96): zeros, the defocus at
    ``spec.defocus_init``."""

    def __init__(self, spec: LensSpec):
        super().__init__()
        self.zernike_coeffs_train = nn.Parameter(torch.full((1, 1, 1), spec.defocus_init))
        self.zernike_coeffs_no_train = nn.Parameter(torch.zeros(3, 1, 1), requires_grad=False)
        self.zernike_coeffs_no_train2 = nn.Parameter(
            torch.zeros(spec.zernike_terms - 4, 1, 1), requires_grad=False
        )

    @property
    def defocus(self) -> torch.Tensor:
        return self.zernike_coeffs_train.reshape(())


def init_lens_params(spec: LensSpec, device: torch.device | str = "cpu") -> OpticsZernike:
    """The reference's init (zeros, defocus at its focusing init) on ``device``."""
    return OpticsZernike(spec).to(device)


def lens_coeffs(lens: OpticsZernike) -> torch.Tensor:
    """Full (T,) coefficient vector; the frozen parts carry no gradient."""
    return torch.cat([
        lens.zernike_coeffs_no_train.detach().reshape(-1),
        lens.zernike_coeffs_train.reshape(-1),
        lens.zernike_coeffs_no_train2.detach().reshape(-1),
    ])


def _downsample_plan(n: int, p: int) -> tuple[int, int]:
    """(pool factor, nearest-upsample factor) replicating the reference.

    ``up == 1`` with ``factor * p != n`` signals the general
    nearest-resize path (see lens_psf): the reference caps the lcm
    upsample at 10x and nearest-resizes for any non-integer ratio."""
    if n % p == 0:
        return n // p, 1
    lcm = np.lcm(n, p)
    up_total = lcm // p  # pool factor after upsampling to lcm
    if up_total > 10:
        return 10, 1
    if (up_total * p) % n:
        return int(up_total), 1
    return int(up_total), int(up_total * p // n)


def lens_psf(
    lens: OpticsZernike,
    consts: LensConstants,
    spec: LensSpec,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """PSF on the sensor grid, (P, P, C) per-channel normalized, and the
    coefficients.  With ``generator`` the height map takes U(-tol, tol)
    manufacturing noise drawn from it."""
    n = spec.wave_res
    height = consts.height_base + lens.defocus.to(consts.height_base.dtype) * consts.defocus_plane
    if generator is not None:
        tol = spec.height_tolerance
        u = torch.rand((n, n), generator=generator, device=height.device, dtype=height.dtype)
        height = height + (-tol + u * (2 * tol))
    phase = consts.phase_scale * height[None]  # (C, N, N)
    field = consts.static_pre * torch.complex(torch.cos(phase), torch.sin(phase))

    # Fresnel propagation on the 1/4-padded grid.
    pad = spec.pad
    field = torch.nn.functional.pad(field, (pad, pad, pad, pad))
    field = torch.fft.ifft2(torch.fft.fft2(field) * consts.fresnel_h)
    field = field[:, pad:-pad, pad:-pad]
    psf = field.real * field.real + field.imag * field.imag  # (C, N, N) intensities

    # Area downsample 896 -> 256 via the reference's lcm path
    # (Utils.py:216-248): nearest-upsample x2 to 1792, 7x7 mean pool.
    p = spec.patch_size
    factor, up = _downsample_plan(n, p)
    if up > 1:
        psf = psf.repeat_interleave(up, dim=1).repeat_interleave(up, dim=2)
    elif factor * p != psf.shape[-1]:
        # The reference's general nearest-resize path (Utils.py:237-243):
        # resize to (factor*p)^2, then a factor x factor mean pool.
        psf = resize_nearest(psf, (factor * p, factor * p))
    psf = psf.reshape(-1, p, factor, p, factor).mean(dim=(2, 4)).permute(1, 2, 0)
    psf = psf / torch.sum(psf, dim=(0, 1), keepdim=True)  # per channel
    return psf, lens_coeffs(lens)


def lens_apply(
    lens: OpticsZernike,
    consts: LensConstants,
    spec: LensSpec,
    img: torch.Tensor,
    mask_mode: str | None = "3",
    generator: torch.Generator | None = None,
    psf_override: torch.Tensor | None = None,
) -> LensResult:
    """Form the sensor image of an NHWC batch in [0, 1].

    ``mask_mode`` follows the reference's ``prueba`` flag
    (Lens.py:269-274): "1" adds the central-disk energy loss, "2"
    hard-crops the PSF to the central disk, "3" does both, None neither.
    ``psf_override`` injects a lab-measured PSF (reference ``psf_lab``)."""
    if psf_override is not None:
        psf = psf_override / torch.sum(psf_override, dim=(0, 1), keepdim=True)
        coeffs = lens_coeffs(lens)
    else:
        psf, coeffs = lens_psf(lens, consts, spec, generator)

    psf_loss = torch.zeros((), dtype=psf.dtype, device=psf.device)
    if mask_mode in ("1", "3"):
        # || psf * mask1 - psf || = Frobenius norm of the PSF inside the disk.
        psf_loss = torch.linalg.vector_norm(psf * consts.mask_keep)
    psf_out = psf
    if mask_mode in ("2", "3"):
        psf_out = psf * consts.mask_keep

    sensor = fft_conv2d_linear(img.to(torch.promote_types(img.dtype, psf_out.dtype)), psf_out)
    # One max over the whole batch, as the reference (Lens.py:312).
    sensor = sensor / torch.amax(sensor)
    return LensResult(sensor=sensor, psf=psf_out, coeffs=coeffs, psf_loss=psf_loss)
