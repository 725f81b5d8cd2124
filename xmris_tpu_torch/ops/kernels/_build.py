"""Build and load the port's CUDA kernels.

All kernels live in ``csrc/*.cu`` and compile, on first use, into ONE shared
library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/xmris_tpu_torch/libxmt_kernels-<hash>.so \\
         csrc/*.cu

The file name carries a hash of the sources, so an edited source builds
anew.  The library is loaded with ``ctypes``; every pointer and the stream
travel as ``c_void_p`` and every C entry returns ``cudaGetLastError()``,
which :func:`check` turns into an exception.  Nothing here runs at import
time: the CPU-only test suite imports every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
# <repo>/build/xmris_tpu_torch (the package's parent directory is the repo).
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "xmris_tpu_torch"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures: name -> argtypes (restype is int, the cudaError_t).
_SIGNATURES = {
    # xr, xi, window, f1t_re, f1t_im, twt_re, twt_im, f2_re, f2_im,
    # out_re, out_im, maxmag, maxidx, b, n_in, n_out, n2, with_maxmag, stream
    "xmt_spectrum": [_P] * 13 + [_I] * 5 + [_P],
    # params, y_re, y_im, t, dxdu, mask, ints, scales, cost, g, h,
    # b, n_t, n_peaks, n_free, n_rows, q_n, factored, w_cs_unit, stream
    "xmt_eq6_normal_eq_v9": [_P] * 11 + [_I] * 7 + [_F, _P],
    # h, g, lam, out, b, f, stream
    "xmt_spd_solve_damped": [_P] * 4 + [_I] * 2 + [_P],
    # h, out, b, f, tikhonov, stream
    "xmt_spd_inverse_diag": [_P] * 2 + [_I] * 2 + [_F, _P],
}

_lib = None
build_seconds: float | None = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built from source on the machine with the card"
        )
    return path


def _sources() -> list[Path]:
    return sorted(list(_CSRC.glob("*.cu")) + list(_CSRC.glob("*.cuh")))


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"libxmt_kernels-{digest.hexdigest()[:12]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(tmp),
        ] + [str(s) for s in _sources() if s.suffix == ".cu"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr[-6000:]}"
            )
        build_seconds = time.perf_counter() - t0
        (BUILD_DIR / "ptxas.log").write_text(proc.stderr)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(name: str, err: int) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {err})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
