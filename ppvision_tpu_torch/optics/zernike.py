"""Zernike polynomial basis (Noll-ordered, RMS-normalized), numpy f64.

Own copy of ``ppvision_tpu/optics/zernike.py``: the reference builds
its phase masks from ``poppy.zernike.zernike_basis(nterms, npix,
outside=0.0)`` (``Face-DeId/Camera/Utils.py:60-63``).  Noll ordering
``j = 1..nterms``, unit RMS over the unit disk, an ``npix`` grid
centered at ``(npix-1)/2`` with disk radius ``npix/2``, zero outside.

The basis is cached on disk under ``PPVISION_TORCH_CACHE`` (default:
``ppvision_tpu_torch/_build/cache`` inside the checkout).
"""

from __future__ import annotations

import math
import os
from functools import lru_cache

import numpy as np

__all__ = ["noll_to_nm", "zernike_basis", "zernike_volume"]

_DEFAULT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build", "cache"
)


def noll_to_nm(j: int) -> tuple[int, int]:
    """Convert a Noll index ``j`` (1-based) to (n, m)."""
    if j < 1:
        raise ValueError(f"Noll index must be >= 1, got {j}")
    n = 0
    j1 = j - 1
    while j1 > n:
        n += 1
        j1 -= n
    m = (-1) ** j * ((n % 2) + 2 * ((j1 + ((n + 1) % 2)) // 2))
    return n, m


def _disk_grid(npix: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pixel grid with unit-disk radius npix/2, centered at (npix-1)/2."""
    c = (npix - 1) / 2.0
    y, x = np.indices((npix, npix), dtype=np.float64)
    y = (y - c) / (npix / 2.0)
    x = (x - c) / (npix / 2.0)
    rho = np.sqrt(x * x + y * y)
    theta = np.arctan2(y, x)
    return rho, theta, rho <= 1.0


def zernike_basis(nterms: int, npix: int, outside: float = 0.0) -> np.ndarray:
    """(nterms, npix, npix) float64 stack of Noll-ordered Zernike terms;
    powers of rho and the angular tables are shared across terms."""
    rho, theta, inside = _disk_grid(npix)
    nm = [noll_to_nm(j) for j in range(1, nterms + 1)]
    max_n = max(n for n, _ in nm)

    rho_pow = np.empty((max_n + 1,) + rho.shape, dtype=np.float64)
    rho_pow[0] = 1.0
    for p in range(1, max_n + 1):
        rho_pow[p] = rho_pow[p - 1] * rho

    ang_cos: dict[int, np.ndarray] = {}
    ang_sin: dict[int, np.ndarray] = {}
    for _, m in nm:
        if m > 0 and m not in ang_cos:
            ang_cos[m] = np.cos(m * theta)
        elif m < 0 and -m not in ang_sin:
            ang_sin[-m] = np.sin(-m * theta)

    basis = np.empty((nterms, npix, npix), dtype=np.float64)
    for idx, (n, m) in enumerate(nm):
        am = abs(m)
        r = np.zeros_like(rho)
        for k in range((n - am) // 2 + 1):
            c = (
                (-1) ** k
                * math.factorial(n - k)
                // (
                    math.factorial(k)
                    * math.factorial((n + am) // 2 - k)
                    * math.factorial((n - am) // 2 - k)
                )
            )
            r += float(c) * rho_pow[n - 2 * k]
        if m == 0:
            z = math.sqrt(n + 1) * r
        elif m > 0:
            z = math.sqrt(2 * (n + 1)) * r * ang_cos[m]
        else:
            z = math.sqrt(2 * (n + 1)) * r * ang_sin[-m]
        basis[idx] = np.where(inside, z, outside)
    return basis


def _cache_dir() -> str:
    d = os.environ.get("PPVISION_TORCH_CACHE", _DEFAULT_CACHE)
    os.makedirs(d, exist_ok=True)
    return d


@lru_cache(maxsize=8)
def zernike_volume(
    resolution: int, n_terms: int, scale_factor: float = 1e-6, use_disk_cache: bool = True
) -> np.ndarray:
    """Zernike basis scaled to height-map units (float32): a coefficient
    of 1.0 is a 1 micron surface deviation (reference
    ``get_zernike_volume``, Face-DeId/Camera/Utils.py:60-63)."""
    path = os.path.join(_cache_dir(), f"zernike_{resolution}_n{n_terms}.npy") if use_disk_cache else ""
    if use_disk_cache and os.path.exists(path):
        vol = np.load(path)
        if vol.shape == (n_terms, resolution, resolution):
            return vol
    vol = (zernike_basis(n_terms, resolution) * scale_factor).astype(np.float32)
    if use_disk_cache:
        tmp = path + f".tmp{os.getpid()}.npy"
        np.save(tmp, vol)
        os.replace(tmp, path)
    return vol
