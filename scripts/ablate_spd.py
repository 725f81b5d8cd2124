#!/usr/bin/env python3
"""Where the dense SPD kernels K6a (damped solve) and K6b (inverse
diagonal) of ``spd.cu`` spend their time: time them with one thing changed,
and K8, which shares their warp factor, as built.

Usage, on a machine with a CUDA card and nvcc, from the root of a checkout:

    python3 scripts/ablate_spd.py [OTHER_CHECKOUT ...] [--rounds N]

Each variant is a copy of a checkout's ``csrc`` (this one, then each
OTHER_CHECKOUT, e.g. the parent commit unpacked with ``git archive``) with
text substitutions, built by nvcc into ``build/ablate_spd/`` and called
through this checkout's wrappers (``spd.spd_solve_damped_dense`` and
``spd_inverse_diag_dense``, whose C entries every checkout shares) on the
bench grid's Hessians: K2's H and g of the bench prior (16 384 voxels,
F = 20, parameters within 20 % of their initial values, ``dxdu`` in
[0.5, 1.5]) in dense form, ``lam = logspace(-5, -1)``.  The substitutions
follow the source's design:

* a thread per voxel, a block's 32 matrices staged in a shared tile (the
  design before the warp redesign): "no tile" (each thread reads its matrix
  from device memory, no dynamic shared memory), "staging only" (the tile's
  diagonal written out, no factor), "factor only" (no substitution or
  inverse diagonal: the factor's diagonal written out);
* a warp per voxel, the factor in registers: "loads only" (no factor, no
  substitution, no inverse diagonal), "factor only", "factor skipped" (the
  substitutions or the inverse diagonal on the loaded matrix), "row of
  L^-1 per lane" (K6b's first warp build: lane i forms row i of L^-1,
  lane j divides its row at step j, each X(j, c) is broadcast and lane c
  picks up its square), the same "with sums by a shared transpose" (the
  squares through a per-warp shared tile), and "4 / 16 voxels a block".
  The two row variants are K6b's operations in K6b's order, bit for bit.

Variants that skip work compute wrong outputs: they measure cost, not a
candidate.  K8 (``lm_v10.cu``) is built as it is in each checkout, and in
the warp design also with its back substitution's padding select taken
out ("back substitution without the padding select"), and run through
``lm_loop_cuda.lm_loop_v10`` on the seeds of ``seed_grid`` at the bench
grid (``max_iter=24``, as ``chip_smoke.py`` phase 3 runs it).

With ``--paths`` it then times, in the same N rounds and orders, the paths
that launch K6a, K6b or K8 with the first OTHER_CHECKOUT's as-built K6a,
K6b and K8 against this checkout's (this checkout's host code, the C
entries swapped): the bench grid at ``kernel_version`` 8 and 10 and
``fit_amares`` at 9 and 8, each on the host clock after a synchronize.

For each checkout and source variant it prints the registers and spills
(the F = 20 instantiation where the kernel is a template); then, in N
rounds (default 3), the time of one launch of every (checkout, kernel,
variant), CUDA events, mean of 20 after 2 warm-up calls (K8: mean of 3
after 1), the checkouts' order reversed every other round; then each one's
median.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REL_CSRC = Path("xmris_tpu_torch") / "ops" / "kernels" / "csrc"

_K6A_THREAD = """    load_and_factor(f, L, [a](int k) { return a[k]; },
                    [lv](float x) { return damp(x, lv); });
    solve_with_factor(L, f, [g, v, f](int i) { return g[v * f + i]; }, y);
    for (int i = 0; i < f; ++i) out[v * f + i] = y[i];"""
_K6B_THREAD = """    load_and_factor(f, L, [a](int k) { return a[k]; },
                    [](float x) { return x; });
    inverse_diag_from_factor(L, f, out + (v0 + threadIdx.x) * f);"""

# The thread design (one thread per voxel, a block's tile in shared memory).
_THREAD = {
    "no tile": [
        ("spd.cu", "const int n_vox = stage_dense_tile(h, tile, v0, b, f);",
         "const int n_vox = min(kDenseVoxels, (int)(b - v0));"),
        ("spd.cu", "const float* a = tile + threadIdx.x * ((f * f) | 1);",
         "const float* a = h + (v0 + threadIdx.x) * f * f;"),
        ("spd.cu", "*smem = kDenseVoxels * ((f * f) | 1) * (int)sizeof(float);",
         "*smem = 0;")],
    "staging only": [
        ("spd.cu", _K6A_THREAD,
         "    for (int i = 0; i < f; ++i) out[v * f + i] = a[i * f + i];"),
        ("spd.cu", _K6B_THREAD,
         "    for (int i = 0; i < f; ++i) out[(v0 + threadIdx.x) * f + i] = "
         "a[i * f + i];")],
    "factor only": [
        ("spd.cu", _K6A_THREAD.split("\n", 2)[2],
         "    for (int i = 0; i < f; ++i) out[v * f + i] = L[tri(i, i)];"),
        ("spd.cu", _K6B_THREAD.split("\n", 2)[2],
         "    for (int i = 0; i < f; ++i) out[(v0 + threadIdx.x) * f + i] = "
         "L[tri(i, i)];")],
}

# A cheap use of every loaded or factored register (kF adds), so that the
# work before it is not dead code.
_SUM_A = ("float x = rhs;\n#pragma unroll\n    for (int j = 0; j < kF; ++j) "
          "x = __fadd_rn(x, a[j]);")
_SUM_A_B = ("float d = 0.f;\n#pragma unroll\n    for (int j = 0; j < kF; ++j) "
            "d = __fadd_rn(d, a[j]);")
_NO_FACTOR = ("spd_factor.cuh",
              "    for (int k = 0; k < kF; ++k) {\n"
              "        float dk = __shfl_sync(kFull, a[k], k);",
              "    for (int k = 0; k < 0; ++k) {\n"
              "        float dk = __shfl_sync(kFull, a[k], k);")
_NO_SOLVE = [
    ("spd.cu", "const float x = warp_back<kF>(a, warp_forward<kF>(a, rhs), f);",
     _SUM_A),
    ("spd.cu", "const float d = warp_inverse_diag<kF>(a, f);", _SUM_A_B)]
_BY_ROW = """    float x[kF];
#pragma unroll
    for (int c = 0; c < kF; ++c) x[c] = (c == lane) ? 1.f : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kF; ++j) {
#pragma unroll
        for (int c = 0; c <= j; ++c) {
            if (lane == j) x[c] = __fdiv_rn(x[c], a[j]);
            const float xjc = __shfl_sync(kFull, x[c], j);
            if (lane > j) x[c] = __fsub_rn(x[c], __fmul_rn(a[j], xjc));
            if (lane == c && j < n) sum = __fadd_rn(sum, __fmul_rn(xjc, xjc));
        }
    }
    return sum;
}"""
_BY_ROW_TRANSPOSE = _BY_ROW.replace(
    "            if (lane == c && j < n) sum = __fadd_rn(sum, "
    "__fmul_rn(xjc, xjc));\n", "").replace("    return sum;\n}", """\
    __shared__ float s_sq[kWarpVoxels][32][33];
    float(*sq)[33] = s_sq[threadIdx.x / 32];
#pragma unroll
    for (int c = 0; c < kF; ++c) sq[lane][c] = __fmul_rn(x[c], x[c]);
    __syncwarp();
    for (int i = lane; i < n; ++i) sum = __fadd_rn(sum, sq[i][lane]);
    __syncwarp();
    return sum;
}""")


def _warp_body(text: str) -> str:
    """warp_inverse_diag's body after its `lane`, up to its closing brace."""
    head = text.split("float warp_inverse_diag(", 1)[1]
    head = head.split("    const int lane = threadIdx.x & 31;\n", 1)[1]
    return head.split("\n}\n", 1)[0] + "\n}"


# The warp design (one warp per voxel, the factor in registers).
_WARP = {
    "loads only": [_NO_FACTOR] + _NO_SOLVE,
    "factor only": _NO_SOLVE,
    "factor skipped": [_NO_FACTOR],
    "row of L^-1 per lane": [("spd.cu", _warp_body, _BY_ROW)],
    "row of L^-1 per lane, sums by a shared transpose": [
        ("spd.cu", _warp_body, _BY_ROW_TRANSPOSE)],
    "4 voxels a block": [("spd.cu", "constexpr int kWarpVoxels = 8;",
                          "constexpr int kWarpVoxels = 4;")],
    "16 voxels a block": [("spd.cu", "constexpr int kWarpVoxels = 8;",
                           "constexpr int kWarpVoxels = 16;")],
}
# K8 built with the warp design's header changed (lm_v10.cu only).
_K8 = {
    "back substitution without the padding select": [(
        "spd_factor.cuh",
        "const float p = real ? __fmul_rn(a[i], x) : 0.f;",
        "const float p = __fmul_rn(a[i], x);")],
}
ENTRIES = {"K6a": "xmt_spd_solve_damped_dense",
           "K6b": "xmt_spd_inverse_diag_dense",
           "K8": "xmt_lm_loop_v10"}


def _design(csrc: Path) -> dict:
    return _THREAD if "stage_dense_tile" in (csrc / "spd.cu").read_text() \
        else _WARP


def _nvcc(d: Path, src: str):
    so = d / f"{src[:-3]}.so"
    return so, subprocess.Popen(
        ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
         str(so), str(d / src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _build_all(label: str, csrc: Path, out: Path):
    """One build of spd.cu per source variant and of lm_v10.cu as built
    (and per K8 variant of the warp design), all nvcc processes started
    together."""
    procs = {}
    design = _design(csrc)
    k8 = _K8 if design is _WARP else {}
    for name, subs in {"as built": [], **design, **k8}.items():
        d = out / label / re.sub(r"[^\w]+", "_", name)
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
        files = {p.name: p.read_text() for p in csrc.iterdir()
                 if p.suffix in (".cu", ".cuh")}
        for fname, old, new in subs:
            if callable(old):
                old = old(files[fname])
            if old not in files[fname]:
                raise SystemExit(f"{label} {name}: {old!r} not in {fname}")
            files[fname] = files[fname].replace(old, new)
        for fname, text in files.items():
            (d / fname).write_text(text)
        if name not in k8:
            procs[(name, "spd.cu")] = _nvcc(d, "spd.cu")
        if name == "as built" or name in k8:
            procs[(name, "lm_v10.cu")] = _nvcc(d, "lm_v10.cu")
    return procs


def _ptxas_lines(err: str, src: str) -> str:
    """Registers/spills of the dense kernels (their F = 20 instantiation
    where they are templates) or of K8."""
    lines = err.splitlines()
    want = []
    for i, ln in enumerate(lines):
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if not m:
            continue
        fn = m.group(1)
        if src == "spd.cu" and ("dense" not in fn
                                or ("ILi" in fn and "ILi20E" not in fn)):
            continue
        tag = "K6a" if "solve" in fn else "K6b" if "inverse" in fn else "K8"
        want += [f"{tag} " + x.split(" : ", 1)[-1].strip()
                 for x in lines[i + 1:i + 5]
                 if "registers" in x or "spill" in x]
    return " / ".join(want)


def main(argv) -> int:
    rounds = 3
    paths = "--paths" in argv
    argv = [a for a in argv if a != "--paths"]
    if "--rounds" in argv:
        i = argv.index("--rounds")
        rounds = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from xmris_tpu_torch import bench_inputs as bi
    from xmris_tpu_torch.fitting.amares import (
        seed_grid,
        seed_plan,
        template_optimum,
    )
    from xmris_tpu_torch.fitting.lm import (
        hashable_pmap,
        normal_eq_plan,
        slab_to_bff,
    )
    from xmris_tpu_torch.fitting.prior import prior_from_csv_text
    from xmris_tpu_torch.ops.bounds import expand_params_batched
    from xmris_tpu_torch.ops.kernels import _build as kb
    from xmris_tpu_torch.ops.kernels import lm_cuda, lm_loop_cuda, spd
    from xmris_tpu_torch.parallel.process import grid_inputs_from_numpy

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    out = ROOT / "build" / "ablate_spd"
    roots = [("this", ROOT)] + [(f"other{i}", Path(a).resolve())
                                for i, a in enumerate(argv)]
    procs = {}
    for label, root in roots:
        for key, val in _build_all(label, root / REL_CSRC, out).items():
            procs[(label,) + key] = val
    libs = {}
    for (label, name, src), (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{label} {name} {src}: nvcc failed\n{err[-3000:]}")
        libs[(label, name, src)] = ctypes.CDLL(str(so))
        print(f"{label} ({dict(roots)[label]}) {name}, {src}: "
              f"{_ptxas_lines(err, src)}", flush=True)

    dev = torch.device("cuda", 0)
    pk = prior_from_csv_text(bi.PK_CSV, "bench PK_CSV")
    ps = hashable_pmap(pk.pmap)
    fids, weight, freqs = bi.make_inputs()
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
    _, g, h = lm_cuda.eq6_normal_equations(grids, re_, im_, t, dxdu,
                                           normal_eq_plan(ps, nf, bi.MHZ, True))
    dense = slab_to_bff(h, nf).contiguous()
    lam = torch.logspace(-5, -1, b, device=dev)
    # K8's inputs, as chip_smoke.py phase 3 makes them.
    amp_slots, ls_plan = seed_plan(pk)
    t_np = (np.arange(bi.N_TIME) / bi.SW).astype(np.float32)
    x_template = template_optimum(fids, pk, torch.from_numpy(t_np).to(dev),
                                  bi.MHZ)
    grid_args = grid_inputs_from_numpy(fids, weight, freqs, t_np, x_template,
                                       pk, dev)
    re8, im8, _, _, t8, xt8, lower, upper, kind = grid_args
    u0 = seed_grid(re8, im8, t8, xt8, lower, upper, kind, pmap_static=ps,
                   mhz=bi.MHZ, amp_slots=amp_slots, ls_plan=ls_plan)
    plan = normal_eq_plan(ps, nf, bi.MHZ, True)
    calls = {
        "K6a": (lambda: spd.spd_solve_damped_dense(dense, g, lam), 20, 2),
        "K6b": (lambda: spd.spd_inverse_diag_dense(dense), 20, 2),
        "K8": (lambda: lm_loop_cuda.lm_loop_v10(
            u0, re8, im8, t8, lower, upper, kind, plan, ps, max_iter=24),
            3, 1),
    }
    cases = []  # (label, kernel, variant, library)
    for (label, name, src), lib in libs.items():
        for kern in (("K8",) if src == "lm_v10.cu" else ("K6a", "K6b")):
            fn = getattr(lib, ENTRIES[kern])
            fn.argtypes = kb._SIGNATURES[ENTRIES[kern]]
            fn.restype = ctypes.c_int
            cases.append((label, kern, name, fn))

    lib = kb.library()
    entries = dict(vars(lib))
    times = {c[:3]: [] for c in cases}
    try:
        for r in range(rounds):
            order = cases if r % 2 == 0 else cases[::-1]
            for label, kern, name, fn in order:
                kb._lib = types.SimpleNamespace(
                    **dict(entries, **{ENTRIES[kern]: fn}))
                call, reps, warm = calls[kern]
                for _ in range(warm):
                    call()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for _ in range(reps):
                    call()
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end) / reps
                times[(label, kern, name)].append(ms)
                print(f"round {r}: {label} {kern} {name}: {ms:.4f} ms",
                      flush=True)
    finally:
        kb._lib = lib
    print(f"medians of {rounds} rounds ({smi}):")
    for (label, kern, name), ms in times.items():
        print(f"  {label} {kern} {name}: {statistics.median(ms):.4f} ms "
              f"({', '.join(f'{x:.4f}' for x in ms)})")
    if paths and len(roots) > 1:
        from xmris_tpu_torch.core.array import Coord, XmrArray
        from xmris_tpu_torch.fitting.amares import fit_amares
        from xmris_tpu_torch.parallel.pipeline import PipelineConfig
        from xmris_tpu_torch.parallel.process import process_grid_planar_raw

        cfg = PipelineConfig(zero_fill_to=bi.ZERO_FILL, autophase="single",
                             ap_optimizer="grid", spec_layout="stacked")
        fit_kw = dict(cfg=cfg, pmap_static=ps, mhz=bi.MHZ,
                      amp_slots=amp_slots, ls_plan=ls_plan, max_iter=24,
                      plateau_streak=3, uniform_t_ok=True)
        da = XmrArray(fids.reshape(bi.GRID + (bi.N_TIME,)),
                      dims=("x", "y", "z", "time"),
                      coords={"time": Coord("time", t_np.astype(np.float64))},
                      attrs={"MHz": bi.MHZ})
        runs = {
            "grid v8 (ms)": (lambda: process_grid_planar_raw(
                *grid_args, **fit_kw, kernel_version=8), 3),
            "grid v10 (ms)": (lambda: process_grid_planar_raw(
                *grid_args, **fit_kw, kernel_version=10), 3),
            "fit_amares v9 (s)": (lambda: fit_amares(da, pk), 1),
            "fit_amares v8 (s)": (lambda: fit_amares(da, pk,
                                                     kernel_version=8), 1),
        }
        swaps = {lab: {ENTRIES[kern]: fn for lab2, kern, name, fn in cases
                       if lab2 == lab and name == "as built"}
                 for lab in ("this", "other0")}
        ptimes = {(lab, path): [] for path in runs for lab in swaps}
        try:
            for r in range(rounds):
                labels = ("other0", "this") if r % 2 == 0 else ("this",
                                                                "other0")
                for path, (fn, reps) in runs.items():
                    for lab in labels:
                        kb._lib = types.SimpleNamespace(
                            **dict(entries, **swaps[lab]))
                        fn()
                        xs = []
                        for _ in range(reps):
                            torch.cuda.synchronize()
                            t0 = time.perf_counter()
                            fn()
                            torch.cuda.synchronize()
                            xs.append(time.perf_counter() - t0)
                        scale = 1e3 if "(ms)" in path else 1.0
                        ptimes[(lab, path)].append(
                            scale * statistics.median(xs))
                        print(f"round {r}: {lab} {path}: "
                              f"{ptimes[(lab, path)][-1]:.4f}", flush=True)
        finally:
            kb._lib = lib
        print(f"paths in turns, medians of {rounds} rounds ({smi}):")
        for (lab, path), xs in ptimes.items():
            print(f"  {lab} {path}: {statistics.median(xs):.4f} "
                  f"({', '.join(f'{x:.4f}' for x in xs)})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
