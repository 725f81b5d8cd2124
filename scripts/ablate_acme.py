#!/usr/bin/env python3
"""What holds the ACME polish kernel (K5) back: time it with one thing changed.

Usage, on a machine with a CUDA card and nvcc, from the root of a checkout:

    python3 scripts/ablate_acme.py

Each variant is ``xmris_tpu_torch/ops/kernels/csrc/acme.cu``, with its
header ``acme_eval.cuh`` written in at its ``#include``, and one text
substitution (the register cap lifted, float32 sums, IEEE divisions, the
fast-math log or sincos), built by nvcc into ``build/ablate/``.  On the
bench grid's unphased flat spectra (16 384 voxels x 2048 points, each
voxel's own pivot, the grid scan's p0+p1 seeds, as ``chip_smoke.py`` phase
3 runs K5) the script prints, for each variant: registers and spills, the
40-step polish's time (CUDA events, mean of 5 after 2 warm-up calls), the
share of voxels whose one evaluation (score and gradient) equals the plain
twin's bit for bit, and the share whose polished phases lie within 0.01
deg of the twin's (``chip_smoke.py``'s gate is 0.99).  Variants other than
the source as built change the arithmetic: they measure cost, not a
candidate.
"""

from __future__ import annotations

import ctypes
import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "xmris_tpu_torch" / "ops" / "kernels" / "csrc" / "acme.cu"
HEADER = SRC.with_name("acme_eval.cuh")

# name -> (old, new) substitutions on the source
VARIANTS = {
    "as built": [],
    "no register cap": [("__launch_bounds__(kMaxThreads, 2)",
                         "__launch_bounds__(kMaxThreads)")],
    "float32 sums": [("using acc_t = double;", "using acc_t = float;")],
    "IEEE divisions": [("    const float q = __fmul_rn(x, r);\n"
                        "    return __fmaf_rn(__fmaf_rn(-q, y, x), r, q);",
                        "    return __fdiv_rn(x, y);")],
    "fast log": [("logf(", "__logf(")],
    "fast sincos": [("sincosf(", "__sincosf(")],
}


def _build(name: str, text: str, out: Path):
    src = out / f"{name.replace(' ', '_')}.cu"
    src.write_text(text)
    so = src.with_suffix(".so")
    proc = subprocess.Popen(
        ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
         str(so), str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return so, proc


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from xmris_tpu_torch import bench_inputs as bi
    from xmris_tpu_torch.ops import kernels as K
    from xmris_tpu_torch.ops.kernels import _build as kb
    from xmris_tpu_torch.ops.kernels import acme_cuda, dft_cuda
    from xmris_tpu_torch.ops.phasing import _grid_phase_search

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    out = ROOT / "build" / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    base = SRC.read_text().replace('#include "acme_eval.cuh"',
                                   HEADER.read_text())
    builds = {}
    for name, subs in VARIANTS.items():
        text = base
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} not in {SRC.name}")
            text = text.replace(old, new)
        builds[name] = _build(name, text, out)
    fns = {}
    for name, (so, proc) in builds.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{err[-3000:]}")
        regs = [ln.strip() for ln in err.splitlines()
                if "registers" in ln or "spill" in ln]
        fn = ctypes.CDLL(str(so)).xmt_acme_polish
        fn.argtypes = kb._SIGNATURES["xmt_acme_polish"]
        fn.restype = ctypes.c_int
        fns[name] = (fn, " / ".join(regs))

    dev = torch.device("cuda", 0)
    fids, weight, freqs = bi.make_inputs()
    re = torch.as_tensor(np.ascontiguousarray(fids.real), device=dev)
    im = torch.as_tensor(np.ascontiguousarray(fids.imag), device=dev)
    win = torch.as_tensor(weight[: bi.N_TIME], device=dev).contiguous()
    f = torch.as_tensor(freqs, device=dev)
    sr, si, _, mi = dft_cuda.spectrum(re, im, bi.ZERO_FILL, window=win,
                                      with_maxmag=True)
    piv = f[mi.long()]
    x_range = float(f[-1] - f[0])
    b, n = sr.shape
    seeds_only = dataclasses.replace(K.PLAIN,
                                     acme_polish=lambda *a, **k: (a[4], None))
    seed = _grid_phase_search(sr, si, f, x_range, piv, False,
                              polish_optimizer="fused",
                              kernels=seeds_only).contiguous()
    _, f1p, g1p = acme_cuda.acme_polish_plain(sr, si, f, piv, seed, x_range,
                                              n_iter=0, with_grad=True)
    pp, _ = acme_cuda.acme_polish_plain(sr, si, f, piv, seed, x_range)

    def call(fn, n_iter, grad=False):
        p = torch.empty((b, 2), device=dev)
        s = torch.empty(b, device=dev)
        g = torch.empty((b, 2), device=dev) if grad else None
        kb.check("xmt_acme_polish", fn(
            sr.data_ptr(), si.data_ptr(), f.data_ptr(), piv.data_ptr(),
            seed.data_ptr(), p.data_ptr(), s.data_ptr(),
            g.data_ptr() if grad else None, b, n, x_range, n_iter, 0,
            acme_cuda.HALF_CELL, acme_cuda.SPAN[0], acme_cuda.SPAN[1],
            kb.stream_ptr(dev)))
        return p, s, g

    for name, (fn, regs) in fns.items():
        _, f1, g1 = call(fn, 0, grad=True)
        pk, _, _ = call(fn, 40)
        for _ in range(2):
            call(fn, 40)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(5):
            call(fn, 40)
        end.record()
        torch.cuda.synchronize()
        same1 = float(((f1 == f1p) & (g1 == g1p).all(1)).double().mean())
        dp0 = torch.remainder(pk[:, 0] - pp[:, 0] + 180.0, 360.0) - 180.0
        ok = (dp0.abs() <= 0.01) & ((pk[:, 1] - pp[:, 1]).abs() <= 0.01)
        print(f"{name}: {start.elapsed_time(end) / 5:.3f} ms; one evaluation "
              f"bit for bit the twin on {same1:.5f} of voxels; phases within "
              f"0.01 deg on {float(ok.double().mean()):.5f}; {regs}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
