#!/usr/bin/env python3
"""Where the SPD kernels of ``spd.cu`` spend their time: K3 (slab damped
solve), K4 (slab inverse diagonal), K6a and K6b (their dense forms) timed
with one thing changed, and K8, which shares their warp factor, as built.

Usage, on a machine with a CUDA card and nvcc, from the root of a checkout:

    python3 scripts/ablate_spd.py [OTHER_CHECKOUT ...] [--rounds N] [--paths]

Each variant is a copy of a checkout's ``csrc`` (this one, then each
OTHER_CHECKOUT, e.g. the parent commit unpacked with ``git archive``) with
text substitutions, built by nvcc into ``build/ablate_spd/`` and called
through this checkout's wrappers (``spd.spd_solve_damped``,
``spd_inverse_diag`` with the CRLB's 1e-12 ridge, ``spd_solve_damped_dense``
and ``spd_inverse_diag_dense``, whose C entries every checkout shares) on
the bench grid's Hessians: K2's H and g of the bench prior (16 384 voxels,
F = 20, parameters within 20 % of their initial values, ``dxdu`` in
[0.5, 1.5]) as K2's slab and in dense form, ``lam = logspace(-5, -1)``.
The substitutions follow the source's design:

* K3/K4 a thread per voxel, the packed factor in local memory (the design
  before the warp redesign of the slab kernels): "loads only" (the
  matrix into the thread's factor array, no factor, no substitution),
  "factor only" (no substitution or inverse diagonal); both write each
  row's sum of the array, so that no load is dead code;
* one warp per voxel, the factor in registers, for all four kernels:
  "loads only" (no factor, no substitution, no inverse diagonal),
  "factor only"; for K3/K4 the slab loaders: "direct slab loads" (lane i
  reads h[(j*f + i)*b + v] where it lies, 8 voxels a block) and its
  "loads only"; the slab tile at 8 or 32 voxels a block in place of 16
  (32 meaning 16 where kF > 24, so that the static tile stays under 48
  KB); and the tile of 8 with K4 held to 64 registers (4 blocks an SM),
  which the shared template gives K6b too.

Variants that skip work ("... only") compute wrong outputs: they measure
cost, not a candidate.  Every other variant's outputs are held bit for bit
against this checkout's as-built ones (NaN at the same places), and the
script stops if one differs.  K8 (``lm_v10.cu``) is built as it is in each
checkout and run through ``lm_loop_cuda.lm_loop_v10`` on the seeds of
``seed_grid`` at the bench grid (``max_iter=24``, as ``chip_smoke.py``
phase 3 runs it).

With ``--paths`` it then times, in the same N rounds and orders, the paths
that launch K3 and K4 with the first OTHER_CHECKOUT's as-built K3 and K4
against this checkout's (this checkout's host code, the two C entries
swapped): the bench grid at the default ``kernel_version`` 9 (median of 3
grids a round) and ``fit_amares`` at 9 (one call a round), each on the
host clock after a synchronize.

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

# The thread design of K3/K4 (one thread per voxel, its packed factor L
# in local memory): each row's sum of L in place of the solve or the
# inverse diagonal.
_ROW_SUMS = """    for (int i = 0; i < f; ++i) {
        float s = 0.f;
        for (int j = 0; j <= i; ++j) s = __fadd_rn(s, L[tri(i, j)]);
        out[(long long)v * f + i] = s;
    }"""
_K3_THREAD_SOLVE = """    solve_with_factor(
        L, f, [g, v, f](int i) { return g[(long long)v * f + i]; }, y);
    for (int i = 0; i < f; ++i) out[(long long)v * f + i] = y[i];"""
_K4_THREAD_INVERSE = "    inverse_diag_from_factor(L, f, out + (long long)v * f);"
_THREAD_NO_SOLVE = [("spd.cu", _K3_THREAD_SOLVE, _ROW_SUMS),
                    ("spd.cu", _K4_THREAD_INVERSE, _ROW_SUMS)]
_THREAD = {
    "loads only": ([("spd.cu", "    for (int k = 0; k < f; ++k) {\n"
                     "        float dk = L[tri(k, k)];",
                     "    for (int k = 0; k < 0; ++k) {\n"
                     "        float dk = L[tri(k, k)];")] + _THREAD_NO_SOLVE,
                   ("K3", "K4")),
    "factor only": (_THREAD_NO_SOLVE, ("K3", "K4")),
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
_SLAB_DIRECT = """// The slab read where it lies: lane i of voxel v reads h[(j*f + i)*b + v].
struct SlabDirect {
    static constexpr int kVoxels = kWarpVoxels;
    const float* h;
    long long b;
    int f;
    __device__ SlabDirect(const float* h_, int b_, int f_)
        : h(h_), b(b_), f(f_) {}
    __device__ auto at(long long v) const {
        const float* hv = h + v;
        const long long bb = b;
        const int n = f;
        return [hv, bb, n](int j, int i) { return hv[(j * n + i) * bb]; };
    }
};

"""
_SLAB = "SlabTile<kF, kSlabVoxels>>("  # both slab entries' layout
_INVERSE = "// diag(A^-1) from the warp factor"
_DIRECT = [("spd.cu", _INVERSE, _SLAB_DIRECT + _INVERSE),
           ("spd.cu", _SLAB, "SlabDirect>(")]


def _tile(voxels: str) -> list:
    """K3's and K4's tile at ``voxels`` voxels a block."""
    return [("spd.cu", _SLAB, f"SlabTile<kF, {voxels}>>(")]


# K4 (and K6b, the same template) held to 64 registers: 4 blocks of 8
# warps an SM.
_CAP_64 = [("spd.cu", "__launch_bounds__(32 * Layout::kVoxels)\n"
            "    spd_inverse_diag_kernel(",
            "__launch_bounds__(32 * Layout::kVoxels, 4)\n"
            "    spd_inverse_diag_kernel(")]
_ALL = ("K3", "K4", "K6a", "K6b")

# The warp design (one warp per voxel, the factor in registers).
_WARP = {
    "loads only": ([_NO_FACTOR] + _NO_SOLVE, _ALL),
    "factor only": (_NO_SOLVE, _ALL),
    "direct slab loads": (_DIRECT, ("K3", "K4")),
    "direct slab loads, loads only": (
        _DIRECT + [_NO_FACTOR] + _NO_SOLVE, ("K3", "K4")),
    "tile of 8 voxels": (_tile("kWarpVoxels"), ("K3", "K4")),
    "tile of 32 voxels": (_tile("(kF <= 24 ? 32 : 16)"), ("K3", "K4")),
    "tile of 8 voxels, 64 registers (K6b too)": (
        _tile("kWarpVoxels") + _CAP_64, ("K4", "K6b")),
}
ENTRIES = {"K3": "xmt_spd_solve_damped",
           "K4": "xmt_spd_inverse_diag",
           "K6a": "xmt_spd_solve_damped_dense",
           "K6b": "xmt_spd_inverse_diag_dense",
           "K8": "xmt_lm_loop_v10"}


def _design(csrc: Path) -> dict:
    return _THREAD if "load_and_factor" in (csrc / "spd.cu").read_text() \
        else _WARP


def _nvcc(d: Path, src: str):
    so = d / f"{src[:-3]}.so"
    return so, subprocess.Popen(
        ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
         str(so), str(d / src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _build_all(label: str, csrc: Path, out: Path):
    """One build of spd.cu per source variant and one of lm_v10.cu as
    built, all nvcc processes started together.  Returns {(variant, src):
    (so, process, kernels)}."""
    procs = {}
    variants = {"as built": ([], _ALL), **_design(csrc)}
    for name, (subs, kernels) in variants.items():
        d = out / label / re.sub(r"[^\w]+", "_", name)
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
        procs[(name, "spd.cu")] = _nvcc(d, "spd.cu") + (kernels,)
        if name == "as built":
            procs[(name, "lm_v10.cu")] = _nvcc(d, "lm_v10.cu") + (("K8",),)
    return procs


def _tag(fn: str) -> str:
    """K3/K4/K6a/K6b/K8 of a kernel's mangled name, in either design."""
    if "lm_loop" in fn:
        return "K8"
    dense = "dense" in fn or "Dense" in fn
    if "solve" in fn:
        return "K6a" if dense else "K3"
    return "K6b" if dense else "K4"


def _ptxas_lines(err: str) -> str:
    """Registers/spills of every kernel of a build (the F = 20
    instantiation where it is a template)."""
    lines = err.splitlines()
    want = []
    for i, ln in enumerate(lines):
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if not m or ("ILi" in m.group(1) and "ILi20E" not in m.group(1)):
            continue
        want += [f"{_tag(m.group(1))} " + x.split(" : ", 1)[-1].strip()
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

    from compare_kernel_builds import _same_bits

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
    for (label, name, src), (so, proc, kernels) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{label} {name} {src}: nvcc failed\n{err[-3000:]}")
        libs[(label, name, src)] = (ctypes.CDLL(str(so)), kernels)
        print(f"{label} ({dict(roots)[label]}) {name}, {src}: "
              f"{_ptxas_lines(err)}", flush=True)

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
        "K3": (lambda: spd.spd_solve_damped(h, g, lam), 20, 2),
        "K4": (lambda: spd.spd_inverse_diag(h, 1e-12), 20, 2),
        "K6a": (lambda: spd.spd_solve_damped_dense(dense, g, lam), 20, 2),
        "K6b": (lambda: spd.spd_inverse_diag_dense(dense), 20, 2),
        "K8": (lambda: lm_loop_cuda.lm_loop_v10(
            u0, re8, im8, t8, lower, upper, kind, plan, ps, max_iter=24),
            3, 1),
    }
    cases = []  # (label, kernel, variant, C entry)
    for (label, name, src), (lib, kernels) in libs.items():
        for kern in kernels:
            fn = getattr(lib, ENTRIES[kern])
            fn.argtypes = kb._SIGNATURES[ENTRIES[kern]]
            fn.restype = ctypes.c_int
            cases.append((label, kern, name, fn))

    lib = kb.library()
    entries = dict(vars(lib))

    def swapped(kern, fn, call):
        kb._lib = types.SimpleNamespace(**dict(entries, **{ENTRIES[kern]: fn}))
        try:
            return call()
        finally:
            kb._lib = lib

    # Every variant that does all the work is bit for bit this checkout's
    # as-built kernel.
    ref = {kern: swapped(kern, fn, calls[kern][0]) for label, kern, name, fn
           in cases if label == "this" and name == "as built" and kern != "K8"}
    for label, kern, name, fn in cases:
        if kern == "K8" or "only" in name:
            continue
        same = _same_bits(swapped(kern, fn, calls[kern][0]), ref[kern])
        print(f"{label} {kern} {name}: "
              f"{'bit for bit' if same else 'DIFFERS from'} this as built",
              flush=True)
        if not same:
            raise SystemExit(f"{label} {kern} {name} differs")

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
            "grid v9 (ms)": (lambda: process_grid_planar_raw(
                *grid_args, **fit_kw, kernel_version=9), 3),
            "fit_amares v9 (s)": (lambda: fit_amares(da, pk), 1),
        }
        swaps = {lab: {ENTRIES[kern]: fn for lab2, kern, name, fn in cases
                       if lab2 == lab and name == "as built"
                       and kern in ("K3", "K4")}
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
