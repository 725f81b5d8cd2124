#!/usr/bin/env python3
"""Where the whole-loop LM kernel (K8) spends its time: time it with one
thing changed.

Usage, on a machine with a CUDA card and nvcc, from the root of a checkout:

    python3 scripts/ablate_lm_v10.py

Each variant is ``xmris_tpu_torch/ops/kernels/csrc/lm_v10.cu`` with text
substitutions, built by nvcc into ``build/ablate_lm_v10/`` and called
through ``lm_loop_cuda.lm_loop_v10`` on the seeded bench grid (16 384
voxels, the bench prior, ``max_iter=24``, the seeds of ``seed_grid``, as
``chip_smoke.py`` phase 3 runs K8).  "as built" stops every voxel as the
kernel does; every other variant also drops the two early exits (the
predicted-decrease exit and the done test), so that each voxel runs all
max_iter + 1 trips whatever its changed arithmetic does to the trajectory,
and compares with "all trips", the source as built under the same change:

* "solve skipped": no factorization or substitution after the first trip
  (whose step is zero), so every trial takes that step again;
* "evaluation skipped": no v9 evaluation; the trial's cost is NaN, so no
  trial is accepted (the carried H stays zero).

The difference between "all trips" and each of the other two is the time
of that stage.

For each variant the script prints registers and spills, the time of one
launch (CUDA events, mean of 3 after a warm-up call), the evaluations it
made and the time per evaluation.  Variants other than "as built" change
the arithmetic: they measure cost, not a candidate.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "xmris_tpu_torch" / "ops" / "kernels" / "csrc"
SRC = CSRC / "lm_v10.cu"

# Every variant but "as built" runs all trips: the two early exits go.
ALL_TRIPS = [
    ("            done = true;\n            break;  // the trial could not "
     "be accepted: the state is final", "            done = true;"),
    ("        __syncthreads();\n        if (done) break;",
     "        __syncthreads();"),
]
EVAL_CALL = """        v9_eval(s_par, s_dx, smem, y_re + v * n_t, y_im + v * n_t, st,
                row_scale, &s_cost_t, s_gt, s_ht, 1, n_t, n_peaks, n_free,
                n_rows, q_n, factored, w_cs_unit, nullptr);"""

# name -> (old, new) substitutions on the source
VARIANTS = {
    "as built": [],
    "all trips": ALL_TRIPS,
    "all trips, solve skipped": ALL_TRIPS + [
        ("        if (tid < 32)\n            warp_factor_solve_any(",
         "        if (tid < 32 && it == 0)\n            warp_factor_solve_any("),
    ],
    "all trips, evaluation skipped": ALL_TRIPS + [
        (EVAL_CALL, "        if (tid == 0) s_cost_t = NAN;"),
    ],
}


def _build(name: str, text: str, out: Path):
    src = out / f"{name.replace(' ', '_').replace(',', '')}.cu"
    src.write_text(text)
    so = src.with_suffix(".so")
    proc = subprocess.Popen(
        ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I",
         str(CSRC), "-o", str(so), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return so, proc


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from xmris_tpu_torch import bench_inputs as bi
    from xmris_tpu_torch.fitting.amares import (
        seed_grid,
        seed_plan,
        template_optimum,
    )
    from xmris_tpu_torch.fitting.lm import hashable_pmap, normal_eq_plan
    from xmris_tpu_torch.fitting.prior import prior_from_csv_text
    from xmris_tpu_torch.ops.kernels import _build as kb
    from xmris_tpu_torch.ops.kernels import lm_loop_cuda
    from xmris_tpu_torch.parallel.process import grid_inputs_from_numpy

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    out = ROOT / "build" / "ablate_lm_v10"
    out.mkdir(parents=True, exist_ok=True)
    base = SRC.read_text()
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
        fn = ctypes.CDLL(str(so)).xmt_lm_loop_v10
        fn.argtypes = kb._SIGNATURES["xmt_lm_loop_v10"]
        fn.restype = ctypes.c_int
        fns[name] = (fn, " / ".join(regs))

    dev = torch.device("cuda", 0)
    fids, weight, freqs = bi.make_inputs()
    pk = prior_from_csv_text(bi.PK_CSV, "bench PK_CSV")
    ps = hashable_pmap(pk.pmap)
    amp_slots, ls_plan = seed_plan(pk)
    t_np = (np.arange(bi.N_TIME) / bi.SW).astype(np.float32)
    x_template = template_optimum(fids, pk, torch.from_numpy(t_np).to(dev),
                                  bi.MHZ)
    re, im, _, _, t_d, xt_d, lower, upper, kind = grid_inputs_from_numpy(
        fids, weight, freqs, t_np, x_template, pk, dev)
    u0 = seed_grid(re, im, t_d, xt_d, lower, upper, kind, pmap_static=ps,
                   mhz=bi.MHZ, amp_slots=amp_slots, ls_plan=ls_plan)
    plan = normal_eq_plan(ps, pk.n_free, bi.MHZ, True)
    loop_args = (u0, re, im, t_d, lower, upper, kind, plan, ps)
    lib = kb.library()
    entries = dict(vars(lib))
    try:
        for name, (fn, regs) in fns.items():
            kb._lib = types.SimpleNamespace(**dict(entries, xmt_lm_loop_v10=fn))

            def call():
                return lm_loop_cuda.lm_loop_v10(*loop_args, max_iter=24,
                                                with_trips=True)

            trips = int(call()[5].sum())
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(3):
                call()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 3
            print(f"{name}: {ms:.4f} ms; {trips} evaluations; "
                  f"{1e6 * ms / trips:.4f} ns per evaluation; {regs}",
                  flush=True)
    finally:
        kb._lib = lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
