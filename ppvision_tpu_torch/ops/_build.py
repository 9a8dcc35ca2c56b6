"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``
(pointers from ``Tensor.data_ptr()``, the stream from
``torch.cuda.current_stream().cuda_stream``).  No PyTorch headers are
included, so a source builds in seconds; the libraries go to
``ppvision_tpu_torch/_build/`` (listed in ``.gitignore``), named by a
hash of their sources so an edited kernel is rebuilt.

Every C entry point returns its ``cudaGetLastError()``; :func:`check`
raises on a non-zero code, since a refused launch never runs and a
later ``synchronize()`` would not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["CUDA_SOURCES", "build_all", "check", "load", "ptxas_report"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
CUDA_SOURCES = ("fftconv", "denseblock", "instats", "winograd", "corr")

_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha1()
    for fn in sorted(os.listdir(CSRC)):
        # The kernel's own source plus the shared header.
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    h.update(" ".join(_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def _start(name: str) -> tuple[subprocess.Popen, str, str] | None:
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [_nvcc(), *_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names=CUDA_SOURCES) -> float:
    """Compile every named source at once (one ``nvcc`` each, all
    started together); returns the wall seconds."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in names}
    for n, job in jobs.items():
        if job is not None:
            _finish(n, job)
    return time.perf_counter() - t0


def ptxas_report(name: str) -> str:
    """The register / shared-memory lines ``ptxas -v`` printed for a
    source at its last build here, and any note that it serialized the
    wgmmas (C7513, C7515) ('' if it was built elsewhere)."""
    path = os.path.join(BUILD_DIR, f"{name}.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        keep = ("registers", "spill", "Compiling entry", "C7513", "C7515")
        return "".join(ln for ln in f if any(k in ln for k in keep))


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; ``signatures``
    maps each C entry point to its ctypes argtypes (restype is int)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            lib = ctypes.CDLL(_lib_path(name))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            lib.ppv_error_string.argtypes = [ctypes.c_int]
            lib.ppv_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.ppv_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
