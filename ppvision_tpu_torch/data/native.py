"""ctypes bridge to the native C++ batch-transform library.

Port of ``ppvision_tpu/data/native.py``.  Builds the repository's
``native/transform.cpp`` (read where it is) with ``g++`` on first use,
with libjpeg where it links, into ``ppvision_tpu_torch/_build/`` (listed
in ``.gitignore``) under a name hashed from the source and flags, and
exposes its PIL-exact crop/resize/flip/normalize batch assembly and
JPEG decode, run on a C++ thread pool.  Where no compiler is available
it says so once; callers check :func:`available`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading

import numpy as np

__all__ = [
    "available",
    "batch_transform",
    "transform_one",
    "has_jpeg",
    "jpeg_dims",
    "decode_jpeg",
    "batch_decode_transform",
]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "transform.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
_BASE = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_lock = threading.Lock()
_lib = None
_tried = False


def _warn_fallback(reason: str) -> None:
    """One-time notice: the PIL transform path is several times slower on
    multi-core hosts, so a silent fallback would look like a data-pipeline
    regression."""
    print(
        f"ppvision_tpu_torch: native transform library unavailable ({reason}); "
        "falling back to the python/PIL path (correct, slower)",
        file=sys.stderr,
    )


def _build(flags: list[str], tag: str) -> str:
    """Compile the source with ``flags`` into the build directory (under a
    temporary name, then renamed, so a process building it at the same
    time never loads half a library); returns the library's path."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(_BASE + flags).encode()).hexdigest()[:12]
    so = os.path.join(BUILD_DIR, f"libppv_transform{tag}_{digest}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        subprocess.run(_BASE + flags[:1] + [SOURCE] + flags[1:] + ["-o", tmp], check=True, capture_output=True)
        os.replace(tmp, so)
    return so


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    i, f, v, s = ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_size_t
    pi, pf = ctypes.POINTER(i), ctypes.POINTER(f)
    lib.ppv_batch_transform.argtypes = [ctypes.POINTER(v), pi, pi, pi, pi, pi, pi, pi, pf, i, i, i, v, v, i]
    lib.ppv_batch_transform.restype = None
    lib.ppv_transform_one.argtypes = [v, i, i, i, i, i, i, pf, i, i, i]
    lib.ppv_transform_one.restype = None
    lib.ppv_has_jpeg.argtypes = []
    lib.ppv_has_jpeg.restype = i
    lib.ppv_jpeg_dims.argtypes = [v, s, pi, pi]
    lib.ppv_jpeg_dims.restype = i
    lib.ppv_decode_jpeg.argtypes = [v, s, v, s, pi, pi]
    lib.ppv_decode_jpeg.restype = i
    lib.ppv_batch_decode_transform.argtypes = [
        ctypes.POINTER(v), ctypes.POINTER(s), pi, pi, pi, pi, pi, pf, i, i, i, v, v, pi, i,
    ]
    lib.ppv_batch_decode_transform.restype = i
    return lib


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        reasons = []
        # With libjpeg where it builds and loads (the bytes -> batch decode
        # pipeline); the transform-only build otherwise.
        for flags, tag in ((["-DPPV_HAS_JPEG", "-ljpeg"], "_jpeg"), ([], "")):
            try:
                _lib = _declare(ctypes.CDLL(_build(flags, tag)))
                return _lib
            except (OSError, subprocess.CalledProcessError) as e:
                reasons.append(f"{tag or 'plain'}: {e}")
        _warn_fallback("; ".join(reasons))
        return None


def _require(jpeg: bool = False):
    lib = _load()
    if lib is None or (jpeg and not lib.ppv_has_jpeg()):
        raise RuntimeError("native jpeg unavailable" if jpeg else "native transform unavailable")
    return lib


def available() -> bool:
    return _load() is not None


def has_jpeg() -> bool:
    """True when the library was built with libjpeg decode support."""
    lib = _load()
    return lib is not None and bool(lib.ppv_has_jpeg())


def transform_one(
    img: np.ndarray, crop: tuple[int, int, int, int], out_hw: tuple[int, int], flip: bool = False,
) -> np.ndarray:
    """Crop (y, x, h, w) + PIL-bilinear resize + optional hflip -> f32 [0,1]."""
    lib = _require()
    img = np.ascontiguousarray(img, np.uint8)
    dh, dw = out_hw
    dst = np.empty((dh, dw, 3), np.float32)
    cy, cx, ch, cw = crop
    lib.ppv_transform_one(
        img.ctypes.data, img.shape[0], img.shape[1], cy, cx, ch, cw,
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), dh, dw, int(flip),
    )
    return dst


def jpeg_dims(data: bytes) -> tuple[int, int]:
    """(H, W) of a JPEG byte stream from a header-only parse."""
    lib = _require(jpeg=True)
    buf = np.frombuffer(data, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.ppv_jpeg_dims(buf.ctypes.data, buf.nbytes, ctypes.byref(h), ctypes.byref(w))
    if rc != 0 or h.value <= 0 or w.value <= 0:
        raise ValueError("corrupt JPEG stream")
    return h.value, w.value


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB, with the libjpeg PIL links, so
    the pixels equal ``PIL.Image.open(...).convert("RGB")``'s.  Raises
    ValueError on corrupt data."""
    lib = _require(jpeg=True)
    h, w = jpeg_dims(data)
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((h, w, 3), np.uint8)
    hh, ww = ctypes.c_int(), ctypes.c_int()
    if lib.ppv_decode_jpeg(buf.ctypes.data, buf.nbytes, out.ctypes.data, out.nbytes, ctypes.byref(hh), ctypes.byref(ww)):
        raise ValueError("corrupt JPEG stream")
    return out


def _geometry(crops: np.ndarray, flips: np.ndarray, n: int):
    crops = np.asarray(crops, np.int32)
    arr = ctypes.c_int * n
    return (*(arr(*crops[:, j].tolist()) for j in range(4)), arr(*[int(f) for f in flips]))


def _norm(mean, std):
    if mean is None:
        return None, None, ()
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    return mean.ctypes.data, std.ctypes.data, (mean, std)


def batch_decode_transform(
    datas: list[bytes],
    crops: np.ndarray,  # (N, 4) int32 (y, x, h, w); y/x -1 = centered
    out_hw: tuple[int, int],
    flips: np.ndarray,  # (N,) bool
    mean: np.ndarray | None = None,
    std: np.ndarray | None = None,
    n_threads: int = 8,
) -> tuple[np.ndarray, np.ndarray]:
    """JPEG bytes -> transformed float32 batch, wholly inside the C++
    pool.  Returns ``(batch, ok)``: a corrupt image gets a zero slot and
    ``ok[i] == False`` (callers drop or resample it)."""
    lib = _require(jpeg=True)
    n = len(datas)
    dh, dw = out_hw
    bufs = [np.frombuffer(d, np.uint8) for d in datas]
    ptrs = (ctypes.c_void_p * n)(*[b.ctypes.data for b in bufs])
    lens = (ctypes.c_size_t * n)(*[b.nbytes for b in bufs])
    ok = (ctypes.c_int * n)()
    dst = np.empty((n, dh, dw, 3), np.float32)
    m, s, _keep = _norm(mean, std)
    rc = lib.ppv_batch_decode_transform(
        ptrs, lens, *_geometry(crops, flips, n),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), dh, dw, n, m, s, ok, n_threads,
    )
    if rc < 0:
        # rc >= 0 counts the corrupt slots (zero-filled, ok = False); a
        # build without libjpeg returns -1 without touching dst.
        raise RuntimeError(f"ppv_batch_decode_transform failed (rc={rc})")
    return dst, np.asarray(ok, np.bool_)


def batch_transform(
    imgs: list[np.ndarray],
    crops: np.ndarray,  # (N, 4) int32 (y, x, h, w)
    out_hw: tuple[int, int],
    flips: np.ndarray,  # (N,) bool
    mean: np.ndarray | None = None,
    std: np.ndarray | None = None,
    n_threads: int = 8,
) -> np.ndarray:
    """uint8 (H, W, 3) images -> crop + PIL-bilinear resize + flip ->
    float32 (N, h, w, 3) batch, on the C++ pool."""
    lib = _require()
    n = len(imgs)
    dh, dw = out_hw
    imgs = [np.ascontiguousarray(im, np.uint8) for im in imgs]
    ptrs = (ctypes.c_void_p * n)(*[im.ctypes.data for im in imgs])
    sh = (ctypes.c_int * n)(*[im.shape[0] for im in imgs])
    sw = (ctypes.c_int * n)(*[im.shape[1] for im in imgs])
    dst = np.empty((n, dh, dw, 3), np.float32)
    m, s, _keep = _norm(mean, std)
    lib.ppv_batch_transform(
        ptrs, sh, sw, *_geometry(crops, flips, n),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), dh, dw, n, m, s, n_threads,
    )
    return dst
