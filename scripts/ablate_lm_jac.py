#!/usr/bin/env python3
"""Where the explicit-Jacobian kernel (K7, K10-K14) spends its time: time it
with one thing changed.

Usage, on a machine with a CUDA card and nvcc, from the root of a checkout:

    python3 scripts/ablate_lm_jac.py

Each variant is ``xmris_tpu_torch/ops/kernels/csrc/lm_jac.cu`` with text
substitutions, built by nvcc into ``build/ablate_lm_jac/`` and called
through ``lm_jac_cuda`` on the bench grid (16 384 voxels, 1024 samples,
the bench prior's parameters within 20 % of their initial values), as K7
(all 25 rows), K12 (the 20 active rows) and K10 (K12's rows on the
factored basis):

* "Gram skipped": no tile sums (the chunk table is still built);
* "build skipped": the bases, residual and Jacobian rows of the first
  chunk only (the tile sums still run over every chunk);
* "2 voxels a block" / "8 voxels a block": another block size;
* "Gram unrolled 2" / "Gram unrolled 8": another unroll of the sample loop.

It prints registers and spills and each launch's time (CUDA events, mean
of 10 after 2 warm-up calls).  Variants that skip work compute wrong
outputs: they measure cost, not a candidate.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
from ablate_lm_v10 import CSRC, _build  # noqa: E402

SRC = CSRC / "lm_jac.cu"
GRAM_LOOP = "#pragma unroll 4\n            for (int c = 0; c < kChunk; ++c) {"

# name -> (old, new) substitutions on the source
VARIANTS = {
    "as built": [],
    "Gram skipped": [
        ("            if (ga[u] < 0) continue;\n            const float* pa",
         "            if (ga[u] < 0 || n_t > 0) continue;\n"
         "            const float* pa"),
    ],
    "build skipped": [
        ("        if (in) {\n            const float ti = t[i];",
         "        if (in && c0 == 0) {\n            const float ti = t[i];"),
        ("        if (in) {\n            ti = t[i];",
         "        if (in && c0 == 0) {\n            ti = t[i];"),
        ("        for (int a = 0; a < nb; ++a) {",
         "        for (int a = 0; a < (c0 == 0 ? nb : 0); ++a) {"),
    ],
    "2 voxels a block": [("constexpr int kVoxels = 4;",
                          "constexpr int kVoxels = 2;")],
    "8 voxels a block": [("constexpr int kVoxels = 4;",
                          "constexpr int kVoxels = 8;")],
    "Gram unrolled 2": [(GRAM_LOOP, GRAM_LOOP.replace("unroll 4", "unroll 2"))],
    "Gram unrolled 8": [(GRAM_LOOP, GRAM_LOOP.replace("unroll 4", "unroll 8"))],
}


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from xmris_tpu_torch import bench_inputs as bi
    from xmris_tpu_torch.fitting.lm import (
        hashable_pmap,
        lorentzian_env_flags,
        normal_eq_plan,
    )
    from xmris_tpu_torch.fitting.prior import prior_from_csv_text
    from xmris_tpu_torch.ops.bounds import expand_params_batched
    from xmris_tpu_torch.ops.kernels import _build as kb
    from xmris_tpu_torch.ops.kernels import lm_jac_cuda

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    out = ROOT / "build" / "ablate_lm_jac"
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
        fn = ctypes.CDLL(str(so)).xmt_eq6_normal_eq_jac
        fn.argtypes = kb._SIGNATURES["xmt_eq6_normal_eq_jac"]
        fn.restype = ctypes.c_int
        fns[name] = (fn, " / ".join(regs))

    dev = torch.device("cuda", 0)
    pk = prior_from_csv_text(bi.PK_CSV)
    ps = hashable_pmap(pk.pmap)
    fids, _, _ = bi.make_inputs()
    b, nf = fids.shape[0], pk.n_free
    rng = np.random.default_rng(0)
    x = np.clip(pk.init_free[None] * rng.uniform(0.8, 1.2, (b, nf)),
                pk.lower, pk.upper)

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    args = (expand_params_batched(f32(x), ps).contiguous(), f32(fids.real),
            f32(fids.imag),
            torch.arange(bi.N_TIME, device=dev, dtype=torch.float32) / bi.SW,
            pk.n_peaks, bi.MHZ)
    active = normal_eq_plan(ps, nf, bi.MHZ, True).active
    flags = lorentzian_env_flags(ps)
    calls = {
        "K7": lambda: lm_jac_cuda.eq6_normal_equations_v3(*args),
        "K12": lambda: lm_jac_cuda.eq6_normal_equations_v5(*args, active),
        "K10": lambda: lm_jac_cuda.eq6_normal_equations_v7(
            *args, active, flags, validate=False),
    }
    lib = kb.library()
    entries = dict(vars(lib))
    try:
        for name, (fn, regs) in fns.items():
            kb._lib = types.SimpleNamespace(
                **dict(entries, xmt_eq6_normal_eq_jac=fn))
            times = []
            for tag, call in calls.items():
                for _ in range(2):
                    call()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for _ in range(10):
                    call()
                end.record()
                torch.cuda.synchronize()
                times.append(f"{tag} {start.elapsed_time(end) / 10:.4f} ms")
            print(f"{name}: {', '.join(times)}; {regs}", flush=True)
    finally:
        kb._lib = lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
