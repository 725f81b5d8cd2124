#!/usr/bin/env python3
"""Where the moment normal-equations kernels K2 (``lm_v9.cu``) and K9
(``lm_v8.cu``) spend their time: time them with one thing changed.

Usage, on a machine with a CUDA card and nvcc, from the root of a checkout:

    python3 scripts/ablate_lm_v9.py [OTHER_CHECKOUT ...] [--rounds N]

Each variant is a copy of a checkout's ``csrc`` (this one, then each
OTHER_CHECKOUT, e.g. the parent commit unpacked with ``git archive``) with
text substitutions, built by nvcc into ``build/ablate_lm_v9/`` and called
through this checkout's wrappers (``lm_cuda.eq6_normal_equations`` and
``eq6_normal_equations_v8``, whose C entries every checkout shares) on the
bench grid: 16 384 voxels, 1024 samples, the bench prior's parameters
within 20 % of their initial values, ``dxdu`` in [0.5, 1.5].  The
substitutions follow the source's design (one block per voxel before the
warp redesign, one warp per voxel after it):

* "direct basis": K2 with ``factored=False`` (an exp and a sincos per peak
  and sample instead of the block-factored tables);
* "gate, all rejected": K2 with ``cost_prev`` = 0, so every voxel stops
  after its cost (the cost stage alone);
* "dense H store": K2 writing each voxel's F x F block contiguous, as K9
  does, instead of the voxel-minor slab;
* "moments skipped": no moment sums (the cost still runs);
* "assembly skipped": no g and H assembly and no H store.

The warp design adds "4 voxels a block"; "pass budget B, N blocks an SM"
for both kernels (B accumulator floats a sweep over the samples, N blocks
an SM as the register cap; as built, K2 takes 64 and 2, K9 112 and 1).  Variants that skip work
compute wrong outputs: they measure cost, not a candidate.

For each checkout and source variant it prints the registers and spills
(the bench shape's instantiation, K = 5 and q_n = 1, where the kernel is a
template); then, in N rounds (default 3), the time of one launch of every
(checkout, variant), CUDA events, mean of 20 after 2 warm-up calls, the
checkouts' order reversed every other round; then each one's median.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import statistics
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REL_CSRC = Path("xmris_tpu_torch") / "ops" / "kernels" / "csrc"

# The block design (one 256-thread block per voxel, `v9_eval`).
_BLOCK = {
    "dense H store": [(
        "lm_v9.cu",
        "g_out + (long long)v * n_free, h_out + v, b, n_t, n_peaks,",
        "g_out + (long long)v * n_free, h_out + (long long)v * n_free * "
        "n_free, 1, n_t, n_peaks,")],
    "moments skipped": [(
        "lm_v9_eval.cuh",
        "for (int item = warp; item < n_peaks + n_pairs; item += kWarps) {",
        "for (int item = warp; item < 0; item += kWarps) {")],
    "assembly skipped": [(
        "lm_v9_eval.cuh",
        "    // ---- 3a. per-row coefficient terms",
        "    return;\n    // ---- 3a. per-row coefficient terms")],
}


def _budget(budget, blocks):
    """K2 and K9 both at ``budget`` accumulator floats a moment pass and
    ``blocks`` blocks an SM (as built: K2 64 and 2, K9 112 and 1)."""
    return [(src, f"constexpr int {name} = {old};",
             f"constexpr int {name} = {new};")
            for src, olds in (("lm_v9.cu", (64, 2)), ("lm_v8.cu", (112, 1)))
            for name, old, new in zip(("kPassBudget", "kMinBlocks"), olds,
                                      (budget, blocks))]


# The warp design (one warp per voxel, `lm_v9_warp.cuh`).
_WARP = {
    "dense H store": [("lm_v9.cu", "constexpr bool kSlabH = true;",
                       "constexpr bool kSlabH = false;")],
    "moments skipped": [(
        "lm_v9_warp.cuh",
        "        moment_pass<K, QN, i0, i1>(c, P == 0 && fuse_cost);",
        "        if (P == 0 && fuse_cost) moment_pass<K, QN, 0, 0>(c, true);")],
    "assembly skipped": [(
        "lm_v9_warp.cuh",
        "    // ---- 3a. per-row coefficient terms",
        "    return false;\n    // ---- 3a. per-row coefficient terms")],
    "4 voxels a block": [("lm_v9_warp.cuh", "constexpr int kVox = 8;",
                          "constexpr int kVox = 4;")],
    **{f"pass budget {b}, {n} block{'s' * (n > 1)} an SM": _budget(b, n)
       for b, n in ((112, 1), (112, 2), (64, 1), (64, 2), (40, 3))},
}
# Variants of K2 alone (the first two are made by the call).
K2_ONLY = ("direct basis", "gate, all rejected", "dense H store")


def _design(csrc: Path) -> dict:
    return _BLOCK if "v9_eval(" in (csrc / "lm_v9.cu").read_text() else _WARP


def _ptxas_lines(err: str) -> str:
    """Registers/spills of the bench shape's kernel (K = 5, q_n = 1 where
    the kernel is a template on them)."""
    lines = err.splitlines()
    want = []
    for i, ln in enumerate(lines):
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if not m or ("ILi" in m.group(1) and "ILi5ELi1E" not in m.group(1)):
            continue
        want += [x.strip() for x in lines[i + 1:i + 5]
                 if "registers" in x or "spill" in x]
    return " / ".join(want)


def _build_all(label: str, csrc: Path, out: Path):
    """One build of lm_v9.cu and lm_v8.cu per source variant, all nvcc
    processes started together."""
    design = _design(csrc)
    procs = {}
    for name, subs in {"as built": [], **design}.items():
        d = out / label / name.replace(" ", "_").replace(",", "")
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
        files = {p.name: p.read_text() for p in csrc.iterdir()
                 if p.suffix in (".cu", ".cuh")}
        for fname, old, new in subs:
            if old not in files[fname]:
                raise SystemExit(f"{label} {name}: {old!r} not in {fname}")
            files[fname] = files[fname].replace(old, new)
        for fname, text in files.items():
            (d / fname).write_text(text)
        for src in ("lm_v9.cu", "lm_v8.cu"):
            if src == "lm_v8.cu" and name in K2_ONLY:
                continue
            so = d / f"{src[:-3]}.so"
            procs[(name, src)] = (so, subprocess.Popen(
                ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                 "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-o", str(so), str(d / src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def main(argv) -> int:
    rounds = 3
    if "--rounds" in argv:
        i = argv.index("--rounds")
        rounds = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from xmris_tpu_torch import bench_inputs as bi
    from xmris_tpu_torch.fitting.lm import hashable_pmap, normal_eq_plan
    from xmris_tpu_torch.fitting.prior import prior_from_csv_text
    from xmris_tpu_torch.ops.bounds import expand_params_batched
    from xmris_tpu_torch.ops.kernels import _build as kb
    from xmris_tpu_torch.ops.kernels import lm_cuda

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    out = ROOT / "build" / "ablate_lm_v9"
    roots = [("this", ROOT)] + [(f"other{i}", Path(a).resolve())
                                for i, a in enumerate(argv)]
    procs = {}
    for label, root in roots:
        for key, val in _build_all(label, root / REL_CSRC, out).items():
            procs[(label,) + key] = val
    fns = {}
    for (label, name, src), (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{label} {name} {src}: nvcc failed\n{err[-3000:]}")
        entry = "xmt_eq6_normal_eq_v9" if src == "lm_v9.cu" else "xmt_eq6_normal_eq_v8"
        fn = getattr(ctypes.CDLL(str(so)), entry)
        fn.argtypes = kb._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        fns[(label, name, src)] = fn
        print(f"{label} ({dict(roots)[label]}) {name}, {src}: "
              f"{_ptxas_lines(err)}", flush=True)

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

    re_, im_, xs = f32(fids.real), f32(fids.imag), f32(x)
    t = torch.arange(bi.N_TIME, device=dev, dtype=torch.float32) / bi.SW
    grids = expand_params_batched(xs, ps).contiguous()
    dxdu = f32(rng.uniform(0.5, 1.5, (b, nf)))
    plans = {f: normal_eq_plan(ps, nf, bi.MHZ, f) for f in (True, False)}
    active = plans[True].active
    zeros = torch.zeros(b, device=dev)

    def k2(factored=True, cost_prev=None):
        return lambda: lm_cuda.eq6_normal_equations(
            grids, re_, im_, t, dxdu, plans[factored], cost_prev=cost_prev)

    def k9():
        return lm_cuda.eq6_normal_equations_v8(grids, re_, im_, t, pk.n_peaks,
                                               bi.MHZ, active, validate=False)

    cases = []  # (label, kernel, variant, source build, call)
    for label, _ in roots:
        for (lab, name, src) in fns:
            if lab != label:
                continue
            if src == "lm_v9.cu":
                cases.append((label, "K2", name, (label, name, src), k2()))
                if name == "as built":
                    cases.append((label, "K2", "direct basis",
                                  (label, name, src), k2(factored=False)))
                    cases.append((label, "K2", "gate, all rejected",
                                  (label, name, src), k2(cost_prev=zeros)))
            else:
                cases.append((label, "K9", name, (label, name, src), k9))

    lib = kb.library()
    entries = dict(vars(lib))
    times = {c[:3]: [] for c in cases}
    try:
        for r in range(rounds):
            order = cases if r % 2 == 0 else cases[::-1]
            for label, kern, name, build, call in order:
                entry = ("xmt_eq6_normal_eq_v9" if kern == "K2"
                         else "xmt_eq6_normal_eq_v8")
                kb._lib = types.SimpleNamespace(**dict(entries,
                                                       **{entry: fns[build]}))
                for _ in range(2):
                    call()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for _ in range(20):
                    call()
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end) / 20
                times[(label, kern, name)].append(ms)
                print(f"round {r}: {label} {kern} {name}: {ms:.4f} ms",
                      flush=True)
    finally:
        kb._lib = lib
    print(f"medians of {rounds} rounds ({smi}):")
    for (label, kern, name), ms in times.items():
        print(f"  {label} {kern} {name}: {statistics.median(ms):.4f} ms "
              f"({', '.join(f'{x:.4f}' for x in ms)})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
