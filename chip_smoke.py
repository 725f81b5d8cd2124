#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py [--profile-dir DIR]

Phases (each ends in ``torch.cuda.synchronize()``; any failed check raises
and the script exits non-zero):

1. device: the card's name and power limit, torch/CUDA versions, TF32 off;
2. build the four CUDA kernels from ``xmris_tpu_torch/ops/kernels/csrc``;
3. each kernel against its plain PyTorch version at the bench shapes
   (32x32x16 voxels, 1024 -> 2048 points, the 5-peak 31P prior), with the
   tolerance printed beside the error, and each one's time;
4. the slice: ``process_grid_planar_raw`` on the full bench grid for three
   grids in a row with the launch counters checked, the fit checked against
   the phantom's ground truth, and the whole kernel path against the plain
   path on the card;
5. timing: median ms per grid over synchronized grids, and voxels/s.

``--profile-dir DIR`` adds a ``torch.profiler`` look at one grid: the
device-busy share on stdout and kernel tables in ``DIR/profile.txt``.  The last line of standard output is one JSON object with
``"ok": true`` and the device.  Without a CUDA device, or outside a
checkout of the repo, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def _sync():
    import torch

    torch.cuda.synchronize()


def _phase(name):
    print(f"== {name}", flush=True)


def _assert_close(name, got, ref, rtol, atol, mask=None):
    """``|got - ref| <= atol + rtol*|ref|`` elementwise (NaN == NaN);
    prints the error beside the limit and returns the max abs error."""
    import torch

    got = got.double()
    ref = ref.double()
    if mask is not None:
        got, ref = got[mask], ref[mask]
    nan_g, nan_r = torch.isnan(got), torch.isnan(ref)
    if not torch.equal(nan_g, nan_r):
        raise AssertionError(f"{name}: NaN pattern differs")
    fin = ~nan_r
    err = (got[fin] - ref[fin]).abs()
    lim = atol + rtol * ref[fin].abs()
    worst = float((err / lim).max()) if err.numel() else 0.0
    max_err = float(err.max()) if err.numel() else 0.0
    print(f"   {name}: max|err| {max_err:.3e}  worst err/limit {worst:.3f} "
          f"(rtol {rtol:g}, atol {atol:.3e})", flush=True)
    if worst > 1.0:
        raise AssertionError(f"{name}: error above tolerance ({worst:.3f}x)")
    return max_err


def _share_within(name, got, ref, rtol, atol, min_share):
    """Share of voxels (rows) whose every entry is within
    ``atol + rtol*|ref|``; raises below ``min_share``."""
    ok = ((got.double() - ref.double()).abs()
          <= atol + rtol * ref.double().abs()).all(-1)
    share = float(ok.double().mean())
    print(f"   {name}: {share:.5f} of voxels within rtol {rtol:g} / atol "
          f"{atol:g} (limit >= {min_share})", flush=True)
    if share < min_share:
        raise AssertionError(f"{name}: too few voxels within tolerance")
    return share


def _time_ms(fn, reps, warmup=2):
    """Mean device time of ``fn()`` in ms, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    _sync()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    _sync()
    return start.elapsed_time(end) / reps


def main(argv) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the GPU",
              file=sys.stderr)
        return 2
    try:
        import xmris_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the root of a checkout of the repository",
              file=sys.stderr)
        return 2
    import numpy as np

    from xmris_tpu_torch import bench_inputs as bi
    from xmris_tpu_torch.fitting.amares import (
        seed_grid,
        seed_plan,
        seeded_fit_grid_raw,
        template_optimum,
    )
    from xmris_tpu_torch.fitting.lm import (
        _expand_params_batched,
        hashable_pmap,
        internal_to_external_torch,
        normal_eq_plan,
    )
    from xmris_tpu_torch.fitting.prior import prior_from_csv_text
    from xmris_tpu_torch.ops import kernels as K
    from xmris_tpu_torch.ops.kernels import _build, dft_cuda, lm_cuda, spd
    from xmris_tpu_torch.parallel.pipeline import PipelineConfig
    from xmris_tpu_torch.parallel.planar_pipeline import (
        spectral_pipeline_planar_raw,
    )
    from xmris_tpu_torch.parallel.process import (
        grid_inputs_from_numpy,
        process_grid_planar_raw,
    )

    profile_dir = (argv[argv.index("--profile-dir") + 1]
                   if "--profile-dir" in argv else None)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # ---- 1. device ----
    _phase("1 device")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          f"device(s)")
    print(f"   tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32}, fp32 matmul precision "
          f"{torch.get_float32_matmul_precision()}", flush=True)

    # ---- 2. build ----
    _phase("2 build")
    t0 = time.perf_counter()
    _build.library()
    print(f"   kernels ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds else 0:.1f} s)",
          flush=True)

    # ---- inputs: the bench phantom and prior ----
    fids, weight, freqs = bi.make_inputs()
    b = fids.shape[0]
    pk = prior_from_csv_text(bi.PK_CSV, "bench PK_CSV")
    ps = hashable_pmap(pk.pmap)
    amp_slots, ls_plan = seed_plan(pk)
    t_np = (np.arange(bi.N_TIME) / bi.SW).astype(np.float32)
    x_template = template_optimum(fids, pk, torch.from_numpy(t_np), bi.MHZ)
    args = grid_inputs_from_numpy(fids, weight, freqs, t_np, x_template, pk,
                                  dev)
    re, im, w_d, f_d, t_d, xt_d, lower, upper, kind = args
    n_free = pk.n_free
    cfg = PipelineConfig(zero_fill_to=bi.ZERO_FILL, autophase="single",
                         ap_optimizer="grid", spec_layout="stacked")
    fit_kw = dict(cfg=cfg, pmap_static=ps, mhz=bi.MHZ, amp_slots=amp_slots,
                  ls_plan=ls_plan, max_iter=24, plateau_streak=3,
                  uniform_t_ok=True)
    _sync()

    # ---- 3. kernels vs plain at bench shapes ----
    _phase("3 kernels vs plain versions (bench shapes)")
    report = {}
    win = w_d[: bi.N_TIME].contiguous()
    ks = dft_cuda.spectrum(re, im, bi.ZERO_FILL, window=win, with_maxmag=True,
                           stacked_out=True)
    kp = dft_cuda.spectrum_plain(re, im, bi.ZERO_FILL, window=win,
                                 with_maxmag=True, stacked_out=True)
    _sync()
    scale = float(torch.maximum(kp[0].abs().max(), kp[1].abs().max()))
    e1 = max(
        _assert_close("K1 spectrum re", ks[0], kp[0], 0.0, 1e-6 * scale),
        _assert_close("K1 spectrum im", ks[1], kp[1], 0.0, 1e-6 * scale),
    )
    if not torch.equal(ks[3].long(), kp[3].long()):
        raise AssertionError("K1: per-voxel argmax indices differ")
    print("   K1 argmax indices identical", flush=True)
    report["spectrum"] = dict(
        err=e1,
        ms=_time_ms(lambda: dft_cuda.spectrum(
            re, im, bi.ZERO_FILL, window=win, with_maxmag=True,
            stacked_out=True), 10),
        plain_ms=_time_ms(lambda: dft_cuda.spectrum_plain(
            re, im, bi.ZERO_FILL, window=win, with_maxmag=True,
            stacked_out=True), 5),
    )

    u0 = seed_grid(re, im, t_d, xt_d, lower, upper, kind, pmap_static=ps,
                   mhz=bi.MHZ, amp_slots=amp_slots, ls_plan=ls_plan)
    x0, dxdu = internal_to_external_torch(u0, lower, upper, kind)
    grids = _expand_params_batched(x0, ps).contiguous()
    dxdu = dxdu.contiguous()
    plan = normal_eq_plan(ps, n_free, bi.MHZ, True)
    c_k, g_k, h_k = lm_cuda.eq6_normal_equations(grids, re, im, t_d, dxdu, plan)
    c_p, g_p, h_p = lm_cuda.eq6_normal_equations_plain(grids, re, im, t_d,
                                                       dxdu, plan)
    _sync()
    _assert_close("K2 cost", c_k, c_p, 1e-5, 0.0)
    e2g = _assert_close("K2 g", g_k, g_p, 1e-4, 1e-3 * float(g_p.abs().max()))
    e2h = _assert_close("K2 H", h_k, h_p, 1e-4, 1e-3 * float(h_p.abs().max()))
    report["eq6_normal_eq_v9"] = dict(
        err=max(e2g, e2h),
        ms=_time_ms(lambda: lm_cuda.eq6_normal_equations(
            grids, re, im, t_d, dxdu, plan), 10),
        plain_ms=_time_ms(lambda: lm_cuda.eq6_normal_equations_plain(
            grids, re, im, t_d, dxdu, plan), 3),
    )

    planted = torch.tensor([5, 777, b - 3], device=dev)
    h_sp = h_k.clone()
    h_sp[0, planted] = -1.0  # H[0, 0] < 0: not SPD
    lam = torch.full((b,), 1e-3, device=dev)
    bad = torch.zeros(b, dtype=torch.bool, device=dev)
    bad[planted] = True
    d_k = spd.spd_solve_damped(h_sp, g_k, lam)
    d_p = spd.spd_solve_damped_plain(h_sp, g_k, lam)
    i_k = spd.spd_inverse_diag(h_sp, 1e-12)
    i_p = spd.spd_inverse_diag_plain(h_sp, 1e-12)
    _sync()
    for name, out in (("K3", d_k), ("K4", i_k)):
        rows_nan = torch.isnan(out).all(1)
        if not torch.equal(rows_nan, bad) or torch.isnan(out[~bad]).any():
            raise AssertionError(f"{name}: NaN rows are not the planted ones")
    print("   K3/K4 NaN rows exactly at the planted non-SPD voxels")
    e3 = _assert_close("K3 solve", d_k, d_p, 2e-6, 1e-7, mask=~bad)
    e4 = _assert_close("K4 inverse diag", i_k, i_p, 2e-4, 0.0, mask=~bad)
    report["spd_solve_damped"] = dict(
        err=e3,
        ms=_time_ms(lambda: spd.spd_solve_damped(h_k, g_k, lam), 10),
        plain_ms=_time_ms(lambda: spd.spd_solve_damped_plain(h_k, g_k, lam), 3),
    )
    report["spd_inverse_diag"] = dict(
        err=e4,
        ms=_time_ms(lambda: spd.spd_inverse_diag(h_k, 1e-12), 10),
        plain_ms=_time_ms(lambda: spd.spd_inverse_diag_plain(h_k, 1e-12), 3),
    )
    for name, r in report.items():
        print(f"   {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
    del ks, kp, c_p, g_p, h_p, h_sp, d_k, d_p, i_k, i_p
    torch.cuda.empty_cache()

    # ---- 4. the slice: three grids through the port's main path ----
    _phase("4 slice: process_grid_planar_raw on the bench grid, 3 grids")
    K.reset_counters()
    outs = []
    t0 = time.perf_counter()
    for _ in range(3):
        outs.append(process_grid_planar_raw(*args, **fit_kw))
    _sync()
    first3_s = time.perf_counter() - t0
    counts = K.counters()
    print(f"   3 grids in {first3_s:.3f} s; counters {counts}")
    for name in K.LAUNCHES:
        if counts["launches"][name] <= 0:
            raise AssertionError(f"kernel {name} was not launched")
        if counts["plain_calls"][name] != 0:
            raise AssertionError(f"plain {name} ran on the main path")
    sr, si, (p0, p1, pivot), x_free, cost, conv, sds = outs[-1]
    n2, n1 = dft_cuda.stacked_spec_shape(bi.N_TIME, bi.ZERO_FILL)
    if sr.shape != (b, n2, n1) or x_free.shape != (b, n_free):
        raise AssertionError("unexpected output shapes")
    for name, val in (("spectra", sr), ("x_free", x_free), ("cost", cost)):
        if not torch.isfinite(val).all():
            raise AssertionError(f"non-finite {name}")
    conv_share = float(conv.float().mean())
    truth = torch.as_tensor(bi.pcr_amplitudes(), device=dev)
    slot = int(pk.pmap.idx[0])
    pcr_err = float(((x_free[:, slot].double() - truth).abs() / truth).median())
    print(f"   converged share {conv_share:.4f} (limit >= 0.95); PCr median "
          f"rel err {pcr_err:.5f} (limit <= 0.05); phases p0 "
          f"{float(p0):.4f} p1 {float(p1):.4f} pivot {float(pivot):.4f}")
    if conv_share < 0.95 or not pcr_err <= 0.05:
        raise AssertionError("fit quality check failed")
    for o in outs[:-1]:  # deterministic grids
        if not torch.equal(o[3], x_free):
            print("   note: repeated grids differ in the last bits")
            break

    plain = process_grid_planar_raw(*args, **fit_kw, kernels=K.PLAIN)
    _sync()
    sr_p, si_p, (p0_p, p1_p, piv_p), x_p, cost_p, conv_p, sds_p = plain
    if float(piv_p) != float(pivot):
        raise AssertionError("plain path chose another pivot")
    dp0 = abs(float(p0) - float(p0_p))
    print(f"   plain path: p0 {float(p0_p):.4f} p1 {float(p1_p):.4f}; "
          f"|dp0| {dp0:.2e} deg (limit 0.5)")
    if dp0 > 0.5:
        raise AssertionError("phase differs from the plain path")
    # Rotate the plain spectra onto the kernel path's phases, then compare.
    x_range = f_d[-1] - f_d[0]

    def phi(a0, a1):
        return (torch.deg2rad(a0) + torch.deg2rad(a1) * ((f_d - pivot) / x_range)
                ).reshape(n2, n1)[None]

    dphi = phi(p0, p1) - phi(p0_p, p1_p)
    c, s = torch.cos(dphi), torch.sin(dphi)
    rot_re, rot_im = sr_p * c - si_p * s, sr_p * s + si_p * c
    sc = float(torch.maximum(sr_p.abs().max(), si_p.abs().max()))
    _assert_close("slice spectra re", sr, rot_re, 0.0, 1e-6 * sc)
    _assert_close("slice spectra im", si, rot_im, 0.0, 1e-6 * sc)
    _assert_close("slice cost", cost, cost_p, 1e-4, 0.0)
    # The LM stops on float32-resolution criteria, so where the two paths'
    # K2 outputs differ in the last bits a few voxels stop at slightly
    # different points of a flat valley (equal cost).  The tolerances of
    # the CPU parity tests must hold for >= 99 % of voxels, and every voxel
    # within a tenth of its CRLB.
    _share_within("slice x_free", x_free, x_p, 2e-3, 2e-3, 0.99)
    dx = (x_free - x_p).abs()
    worst = float((dx / (2e-3 + 0.1 * sds)).max())
    print(f"   slice x_free: max |dx| / (2e-3 + 0.1*CRLB) = {worst:.3f} "
          f"(limit 1)")
    if not worst <= 1.0:
        raise AssertionError("x_free differs by more than 0.1 CRLB")
    _share_within("slice CRLB", sds, sds_p, 2e-2, 1e-4, 0.99)
    if not torch.equal(conv, conv_p):
        print(f"   note: converged flags differ on "
              f"{int((conv != conv_p).sum())} voxels")
    del plain, sr_p, si_p, rot_re, rot_im
    torch.cuda.empty_cache()

    # ---- 5. timing ----
    _phase("5 timing")
    times = []
    for _ in range(7):
        _sync()
        t0 = time.perf_counter()
        process_grid_planar_raw(*args, **fit_kw)
        _sync()
        times.append(time.perf_counter() - t0)
    ms = 1e3 * float(np.median(times))
    print(f"   grid times ms: {[round(1e3 * x, 3) for x in times]}")
    print(f"   median {ms:.3f} ms/grid = {b / (ms / 1e3):.1f} voxels/s "
          f"({b} voxels)")
    stages = {
        "spectral stage": lambda: spectral_pipeline_planar_raw(
            re, im, w_d, f_d, cfg),
        "seeding": lambda: seed_grid(
            re, im, t_d, xt_d, lower, upper, kind, pmap_static=ps,
            mhz=bi.MHZ, amp_slots=amp_slots, ls_plan=ls_plan),
        "seeded fit + CRLB": lambda: seeded_fit_grid_raw(
            re, im, t_d, xt_d, lower, upper, kind,
            **{k: v for k, v in fit_kw.items() if k != "cfg"}),
    }
    for name, fn in stages.items():
        st = []
        for _ in range(5):
            _sync()
            t0 = time.perf_counter()
            fn()
            _sync()
            st.append(time.perf_counter() - t0)
        print(f"   {name}: median {1e3 * float(np.median(st)):.3f} ms")
    if profile_dir:
        _profile(process_grid_planar_raw, args, fit_kw, ms, profile_dir)

    replaces = {
        "spectrum": ("xmris_tpu_torch/ops/kernels/csrc/spectrum.cu",
                     "xmris_tpu/ops/kernels/dft_pallas.py:324"),
        "eq6_normal_eq_v9": ("xmris_tpu_torch/ops/kernels/csrc/lm_v9.cu",
                             "xmris_tpu/ops/kernels/lm_pallas.py:1937"),
        "spd_solve_damped": ("xmris_tpu_torch/ops/kernels/csrc/spd.cu",
                             "xmris_tpu/ops/kernels/spd.py:312"),
        "spd_inverse_diag": ("xmris_tpu_torch/ops/kernels/csrc/spd.cu",
                             "xmris_tpu/ops/kernels/spd.py:377"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": replaces[name][0],
         "replaces": replaces[name][1],
         "launches": counts["launches"][name],
         "max_abs_err": report[name]["err"], "ms": report[name]["ms"],
         "plain_ms": report[name]["plain_ms"]}
        for name in K.LAUNCHES
    ]
    print(json.dumps({"ms_per_grid": ms, "voxels_per_s": b / (ms / 1e3),
                      "voxels": b}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _profile(fn, args, kw, grid_ms, out_dir):
    """One grid under torch.profiler: device busy time as a share of the
    unprofiled median grid time ``grid_ms``, and kernel tables by device
    and by host time to ``out_dir/profile.txt``."""
    from pathlib import Path

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*args, **kw)
    _sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*args, **kw)
        _sync()
    events = prof.events()
    busy_us = sum(e.device_time for e in events
                  if e.device_type == DeviceType.CUDA)
    kernels = sum(1 for e in events if e.device_type == DeviceType.CUDA)
    avg = prof.key_averages()
    by_dev = avg.table(sort_by="self_cuda_time_total", row_limit=30)
    by_cpu = avg.table(sort_by="cpu_time_total", row_limit=30)
    out = Path(out_dir)
    out.mkdir(exist_ok=True)
    (out / "profile.txt").write_text(by_dev + "\n\n" + by_cpu)
    print(f"   profile: {kernels} device kernels per grid, device busy "
          f"{busy_us / 1e3:.3f} ms = {100 * busy_us / 1e3 / grid_ms:.1f} % "
          f"of the unprofiled median {grid_ms:.3f} ms/grid")
    print("\n".join(by_dev.splitlines()[:16]))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
