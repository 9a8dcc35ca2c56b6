"""Plain optics: the Zernike basis, the Face-DeId camera and the
captioner's Fresnel lens, in float64 on the device.

Follows the published models (Face-DeId/Camera/Optics.py and
Image_Caption/Camera/Lens.py of carlosh93/privacy-preserving-vision):
Noll-ordered unit-RMS Zernike terms as ``poppy.zernike.zernike_basis``
gives them, two-step scaled-FFT propagation for the camera, padded
Fresnel propagation and the lcm area downsample for the lens.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["zernike_terms", "camera_psf", "camera_sensor", "lens_psf", "lens_sensor", "disk_mask"]


def _noll(j: int) -> tuple[int, int]:
    n, j1 = 0, j - 1
    while j1 > n:
        n += 1
        j1 -= n
    m = (-1) ** j * ((n % 2) + 2 * ((j1 + ((n + 1) % 2)) // 2))
    return n, m


def zernike_terms(indices, npix: int) -> np.ndarray:
    """(len(indices), npix, npix) float64 Zernike terms for 0-based Noll
    indices: unit RMS over the disk of radius npix/2 centred at
    (npix-1)/2, zero outside."""
    c = (npix - 1) / 2.0
    y, x = np.indices((npix, npix), dtype=np.float64)
    y, x = (y - c) / (npix / 2.0), (x - c) / (npix / 2.0)
    rho, theta = np.sqrt(x * x + y * y), np.arctan2(y, x)
    out = np.zeros((len(indices), npix, npix))
    for i, idx in enumerate(indices):
        n, m = _noll(idx + 1)
        am = abs(m)
        r = np.zeros_like(rho)
        for k in range((n - am) // 2 + 1):
            coef = (-1) ** k * math.factorial(n - k) // (
                math.factorial(k) * math.factorial((n + am) // 2 - k) * math.factorial((n - am) // 2 - k))
            r += coef * rho ** (n - 2 * k)
        if m == 0:
            z = math.sqrt(n + 1) * r
        elif m > 0:
            z = math.sqrt(2 * (n + 1)) * r * np.cos(m * theta)
        else:
            z = math.sqrt(2 * (n + 1)) * r * np.sin(-m * theta)
        out[i] = np.where(rho <= 1.0, z, 0.0)
    return out


def _height_map(coeffs: np.ndarray, npix: int, scale: float = 1e-6) -> np.ndarray:
    """Sum of coefficient x term over the non-zero coefficients (metres)."""
    nz = np.flatnonzero(coeffs)
    if nz.size == 0:
        return np.zeros((npix, npix))
    return np.einsum("t,thw->hw", coeffs[nz], zernike_terms(nz, npix)) * scale


def _delta_n(lam_um: np.ndarray) -> np.ndarray:
    """|n(fused silica) - n(air)| (Sellmeier and Ciddor), microns."""
    l2 = lam_um**2
    n_lens = np.sqrt(1 + 0.6961663 * l2 / (l2 - 0.0684043**2) + 0.4079426 * l2 / (l2 - 0.1162414**2)
                     + 0.8974794 * l2 / (l2 - 9.896161**2))
    inv = lam_um**-2.0
    return np.abs(n_lens - (1 + 0.05792105 / (238.0185 - inv) + 0.00167917 / (57.362 - inv)))


def camera_psf(coeffs: np.ndarray, cam: dict, device) -> torch.Tensor:
    """The Face-DeId camera's PSF, (N, N, C) float64 summing to 1, from
    the full (T,) Zernike coefficient vector."""
    n = cam["n"]
    lam = np.asarray(cam["wavelengths"], np.float64)[:, None, None]
    f = 1.0 / (1.0 / cam["zi"] + 1.0 / cam["z0"])
    f_lam = f * _delta_n(np.float64(0.55)) / _delta_n(lam * 1e6)
    k = 2 * np.pi / lam
    l_len, l_sen = 4.0 * cam["aperture_radius"], cam["pixel_pitch"] * n
    du, dx2 = l_len / n, l_sen / n
    u = np.arange(-l_len / 2, l_len / 2, du)[:n]
    xx, yy = np.meshgrid(u, u, indexing="ij")
    xy = xx**2 + yy**2
    aperture = np.sqrt(xy) <= cam["aperture_radius"]
    fx = np.roll(np.arange(-1 / (2 * du), 1 / (2 * du), 1 / l_len)[:n], -(n // 2))
    fxx, fyy = np.meshgrid(fx, fx, indexing="ij")
    x2 = np.arange(-l_sen / 2, l_sen / 2, dx2)[:n]
    sx, sy = np.meshgrid(x2, x2, indexing="ij")
    xy2 = sx**2 + sy**2
    height = _height_map(np.asarray(coeffs, np.float64), n)
    phase = (k * f_lam * height - k / (2 * f_lam) * xy + k / (2 * cam["scene_depth"]) * xy
             + np.pi / (lam * cam["zi"] * l_len) * (l_len - l_sen) * xy)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    field = t(aperture * np.exp(1j * phase))
    field = torch.fft.fftshift(field, dim=(-2, -1))
    dims = (0, 1, 2) if cam["couple_wavelengths"] else (1, 2)
    field = torch.fft.fftn(field, dim=dims) * t(np.exp(-1j * np.pi * lam * cam["zi"] * l_len / l_sen
                                                        * (fxx**2 + fyy**2)))
    field = torch.fft.ifftshift(torch.fft.ifftn(field, dim=dims), dim=(-2, -1))
    amp = (l_sen / l_len) * du**2 / dx2**2
    field = field * t(amp * np.exp(-1j * np.pi / (lam * cam["zi"] * l_sen) * (l_len - l_sen) * xy2))
    psf = field.real**2 + field.imag**2
    return (psf / psf.sum()).permute(1, 2, 0)


def camera_sensor(img: torch.Tensor, psf: torch.Tensor) -> torch.Tensor:
    """Circular convolution of an NHWC batch with the centred PSF, then
    each image divided by its own maximum; float64."""
    n = psf.shape[0]
    kernel = torch.roll(psf, (-(n // 2), -(n // 2)), (0, 1))
    spec = torch.fft.fft2(img.double(), dim=(1, 2)) * torch.fft.fft2(kernel, dim=(0, 1))
    out = torch.fft.ifft2(spec, dim=(1, 2)).real
    return out / out.amax(dim=(1, 2, 3), keepdim=True)


def disk_mask(p: int, radius: int) -> np.ndarray:
    """(P, P) central disk as the published lens draws it (``cv2.circle``,
    filled), or the exact disk r <= radius where cv2 is not installed."""
    try:
        import cv2  # noqa: PLC0415

        m = np.zeros((p, p), np.float64)
        cv2.circle(img=m, center=[p // 2, p // 2], radius=radius, color=1.0, thickness=-1, lineType=cv2.FILLED)
        return m
    except ImportError:
        yy, xx = np.indices((p, p), dtype=np.float64)
        return (np.hypot(yy - p // 2, xx - p // 2) <= radius).astype(np.float64)


def lens_psf(coeffs: torch.Tensor, lens: dict, noise: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """The captioner's lens PSF on the sensor grid, (P, P, C) float64,
    each channel summing to 1 before the crop, and the PSF loss.
    ``coeffs`` is the (T,) coefficient vector (differentiable);
    ``noise`` an (N, N) U[0, 1) draw for the height tolerance, or None."""
    n, p = lens["wave_res"], lens["patch_size"]
    dev = coeffs.device
    c_np = coeffs.detach().cpu().double().numpy()
    nz = np.flatnonzero(c_np)
    terms = torch.from_numpy(zernike_terms(nz, n) * 1e-6).to(dev) if nz.size else None
    height = torch.zeros((n, n), dtype=torch.float64, device=dev)
    if terms is not None:
        height = torch.einsum("t,thw->hw", coeffs.double()[torch.from_numpy(nz).to(dev)], terms)
    if noise is not None:
        tol = lens["height_tolerance"]
        height = height + (-tol + noise.double() * (2 * tol))
    lam = np.asarray(lens["wavelengths"], np.float64)[:, None, None]
    k = 2 * np.pi / lam
    dn = np.asarray(lens["refractive_idcs"], np.float64)[:, None, None] - 1
    x, y = np.mgrid[-n // 2: n // 2, -n // 2: n // 2].astype(np.float64)
    size = n * lens["sample_interval"]
    curv = np.sqrt((x / n * size) ** 2 + (y / n * size) ** 2 + lens["depth"] ** 2)[None]
    aperture = (np.sqrt(x**2 + y**2) < np.amax(x))[None]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    phase = t(k * dn) * height[None]
    field = t(aperture * np.exp(1j * k * curv)) * torch.polar(torch.ones_like(phase), phase)
    pad = n // 4
    m = n + 2 * pad
    fx = np.fft.ifftshift(np.mgrid[-m // 2: m // 2].astype(np.float64) / (lens["sample_interval"] * m))
    fxx, fyy = np.meshgrid(fx, fx, indexing="ij")
    h = t(np.exp(-1j * np.pi * lam * lens["sensor_distance"] * (fxx**2 + fyy**2)[None]))
    field = torch.fft.ifft2(torch.fft.fft2(F.pad(field, (pad, pad, pad, pad))) * h)[:, pad:-pad, pad:-pad]
    psf = field.real**2 + field.imag**2
    # Area downsample n -> p: nearest upsample to lcm(n, p), mean pool.
    lcm = math.lcm(n, p)
    up, factor = lcm // n, lcm // p
    psf = psf.repeat_interleave(up, 1).repeat_interleave(up, 2)
    psf = psf.reshape(-1, p, factor, p, factor).mean(dim=(2, 4)).permute(1, 2, 0)
    psf = psf / psf.sum(dim=(0, 1), keepdim=True)
    keep = t(disk_mask(p, lens["mask_radius_px"]))[:, :, None]
    return psf * keep, torch.linalg.vector_norm(psf * keep)


def lens_sensor(img: torch.Tensor, psf: torch.Tensor) -> torch.Tensor:
    """The published linear (zero-padded) FFT convolution of an NHWC batch
    with a centred PSF, with its one-pixel crop and nearest resize back,
    then one maximum over the whole batch; float64."""
    b, h, w, _ = img.shape
    ph, pw = h // 2, w // 2
    padded = F.pad(img.double(), (0, 0, pw, pw, ph, ph))
    # psf2otf: pad the PSF to (2h, 2w), the extra row/column at the top-left.
    dh, dw = 2 * h - psf.shape[0], 2 * w - psf.shape[1]
    top, left = dh // 2 + 1, dw // 2 + 1
    kp = F.pad(psf, (0, 0, left, dw - left, top, dh - top))
    otf = torch.fft.fft2(torch.fft.ifftshift(kp, dim=(0, 1)), dim=(0, 1))
    z = torch.fft.ifft2(torch.fft.fft2(padded, dim=(1, 2)) * otf[None], dim=(1, 2))
    out = torch.sqrt(z.real**2 + z.imag**2 + 1e-24)[:, ph + 1: 2 * h - ph, pw + 1: 2 * w - pw]
    rows = torch.clamp((torch.arange(h) * (h - 1)) // h, 0, h - 2).to(img.device)
    cols = torch.clamp((torch.arange(w) * (w - 1)) // w, 0, w - 2).to(img.device)
    out = out[:, rows][:, :, cols]
    return out / out.amax()
