"""Build and load the port's CUDA kernels.

Each kernel source ``csrc/<name>.cu`` compiles, on first use, into its own
shared library with a plain C interface; the nvcc processes of all sources
start together and run in parallel::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/xmris_tpu_torch/libxmt_<name>-<hash>.so \\
         csrc/<name>.cu

The file name carries a hash of the source and of every ``csrc/*.cuh``, so
an edited source builds anew.  The libraries are loaded with ``ctypes``;
every pointer and the stream travel as ``c_void_p`` and every C entry
returns ``cudaGetLastError()``, which :func:`check` turns into an exception.
Nothing here runs at import time: the CPU-only test suite imports every
module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import types
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
    # xr, xi, window, tw (n_out, 2), out_re, out_im, maxmag, maxidx, b, n_in,
    # log2n, scale, with_maxmag, vec_load, stream
    "xmt_spectrum_fft": [_P] * 8 + [_I] * 3 + [_F] + [_I] * 2 + [_P],
    # params, y_re, y_im, t, dxdu, mask, cost_prev, ints, scales, cost, g, h,
    # b, n_t, n_peaks, n_free, n_rows, q_n, factored, w_cs_unit, stream
    "xmt_eq6_normal_eq_v9": [_P] * 12 + [_I] * 7 + [_F, _P],
    # the same, K2's wide build (csrc/lm_v9_wide.cu)
    "xmt_eq6_normal_eq_v9_wide": [_P] * 12 + [_I] * 7 + [_F, _P],
    # params, y_re, y_im, t, mask, ints, scales, cost, g, h, b, n_t, n_peaks,
    # n_rows, w_cs_unit, stream
    "xmt_eq6_normal_eq_v8": [_P] * 10 + [_I] * 4 + [_F, _P],
    # h, g, lam, out, b, f, stream
    "xmt_spd_solve_damped": [_P] * 4 + [_I] * 2 + [_P],
    # h, out, b, f, tikhonov, stream
    "xmt_spd_inverse_diag": [_P] * 2 + [_I] * 2 + [_F, _P],
    # h (B, F, F), out, b, f, stream
    "xmt_spd_inverse_diag_dense": [_P] * 2 + [_I] * 2 + [_P],
    # h (B, F, F), g, lam, out, b, f, stream
    "xmt_spd_solve_damped_dense": [_P] * 4 + [_I] * 2 + [_P],
    # params, y_re, y_im, t, rows, mask, g_zero, cost, g, h, b, n_t, n_peaks,
    # n_rows, factored, w_cs_unit, stream
    "xmt_eq6_normal_eq_jac": [_P] * 10 + [_I] * 5 + [_F, _P],
    # u0, y_re, y_im, t, lo, hi, kind, pmap_idx, pmap_scale, pmap_offset,
    # ints, scales, u, cost, n_acc, done, h, trips, b, n_t, n_peaks, n_free,
    # n_rows, q_n, factored, w_cs_unit, lam0, ftol, max_iter,
    # plateau_streak, stream
    "xmt_lm_loop_v10": [_P] * 18 + [_I] * 7 + [_F] * 3 + [_I] * 2 + [_P],
    # re, im, coords, pivots, p_init, p_out, f_out, g_out, b, n, x_range,
    # n_iter, p0_only, half_cell, span0, span1, stream
    "xmt_acme_polish": [_P] * 8 + [_I] * 2 + [_F] + [_I] * 2 + [_F] * 3 + [_P],
    # re, im, stride_re, stride_im, freqs, voxel_idx, freq_idx, p_out, n,
    # dec, p0_only, n_coarse, n_fine, half_cell, span0, span1, stream
    "xmt_acme_search": [_P] * 2 + [_I] * 2 + [_P] * 4 + [_I] * 5 + [_F] * 3
    + [_P],
}

_lib = None
_LOCK = threading.Lock()
build_seconds: float | None = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built from source on the machine with the card"
        )
    return path


def _headers() -> list[Path]:
    return sorted(_CSRC.glob("*.cuh"))


def _target(src: Path) -> Path:
    digest = hashlib.sha256()
    for path in [src] + _headers():
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libxmt_{src.stem}-{digest.hexdigest()[:12]}.so"


def library() -> types.SimpleNamespace:
    """The C entries of every kernel library, building them first if needed
    (one nvcc per source, all in parallel).  One thread builds and loads
    while the others wait (the shards of a mesh launch from threads)."""
    if _lib is not None:
        return _lib
    with _LOCK:
        return _lib if _lib is not None else _build_and_load()


def _build_and_load() -> types.SimpleNamespace:
    global _lib, build_seconds
    sources = sorted(_CSRC.glob("*.cu"))
    todo = [(src, _target(src)) for src in sources if not _target(src).exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = []
        for src, out in todo:
            tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [
                nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                "-o", str(tmp), str(src),
            ]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        logs, failed = [], []
        for src, out, tmp, proc in procs:
            _, err = proc.communicate()
            logs.append(f"== {src.name}\n{err}")
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{err[-6000:]}")
            else:
                os.replace(tmp, out)
        build_seconds = time.perf_counter() - t0
        (BUILD_DIR / "ptxas.log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
    entries = {}
    for src in sources:
        lib = ctypes.CDLL(str(_target(src)))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                entries[name] = fn
    missing = sorted(set(_SIGNATURES) - set(entries))
    if missing:
        raise RuntimeError(f"kernel libraries lack the entries {missing}")
    _lib = types.SimpleNamespace(**entries)
    return _lib


def check(name: str, err: int) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {err})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
