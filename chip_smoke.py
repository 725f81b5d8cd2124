#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py [--profile-dir DIR]

Phases (each ends in ``torch.cuda.synchronize()``; any failed check raises
and the script exits non-zero):

1. device: the card's name and power limit, torch/CUDA versions, TF32 off;
2. build the fifteen CUDA kernels from ``xmris_tpu_torch/ops/kernels/csrc``
   (one nvcc per source, in parallel), and print ptxas's registers and
   spills of K2 and K9 (one warp per voxel, the moments in registers;
   their bench-shape instantiations, K = 5 and q_n = 1), K3, K4, K6a and
   K6b (one warp per voxel, the factor in registers; F = 20) and K8;
3. each kernel against its plain PyTorch version at the bench shapes
   (32x32x16 voxels, 1024 -> 2048 points, the 5-peak 31P prior), with the
   tolerance printed beside the error, and each one's time, its plain
   version's, a single PyTorch call's where one computes the same function,
   and its bound on the card (K1 on both routes: the FFT kernel at the
   bench shape and at 500 -> 1024, which has no split, the split kernel at
   768 -> 1536; the dense route, not a kernel, at 1000 -> 1500 against the
   plain version with its own counter; K3, K4 (with the CRLB's 1e-12
   ridge and without), K6a and K6b each bit for bit against its twin, K3
   against K6a and K4 without the ridge against K6b, the dense pair beside
   the cuSOLVER composition of the same functions as a yardstick; K8
   by the share of voxels within the reference's tolerances; K13 and K14
   bit for bit K7, K11 K12 on its unmasked voxels, K10 against K11 per
   entry; K2's accept gate: the cost bit for bit, g and H on the improving
   voxels);
   3b. the free-g instantiations: K2 at K = 5, q_n = 2, F = 25 held per
   entry, and K3, K4, K6a and K6b at F = 25 bit for bit (NaN rows at the
   planted non-SPD voxels), each with its time and bound;
4. the slice: ``process_grid_planar_raw`` (single-pivot autophase) on the
   full bench grid for three grids in a row with the launch counters
   checked, the fit checked against the phantom's ground truth, and the
   whole kernel path against the plain path on the card;
   4b. ``process_grid_planar_raw`` with per-voxel autophase (K1 and K5)
   against the plain path;
   4c. ``fit_amares`` on the bench grid as a labeled (x, y, z, time) array
   (K2, K3 and K6b) against the phantom's truth and the plain path;
   4d-4k. ``process_grid_planar_raw`` at ``kernel_version`` 10 (K8), 3
   (K7), 5 (K12), 8 (K9), 6 (K11), 7 (K10), 2 (K13) and 1 (K14), the
   last seven with K6a and K6b, each against the phantom's truth and, by
   the share of voxels within the reference's tolerances, the v9 grid of 4;
   4l. ``fit_amares(kernel_version=10)`` against the truth and 4c's maps;
   4m. ``fit_amares(kernel_version=8)`` (K9 + K6a + K6b) likewise;
   4n. ``lm_fit_batched_pallas(gate_rejects=True)`` at 9 and 10 (K2 with
   its gate, not K8) bit for bit the ungated v9 fit of the bench seeds;
   4o. the free-g grid: ``seeded_fit_grid_raw`` with the bench prior's g
   rows freed to (0, 1) from 0.1 (F = 25), the g scan and the VARPRO
   override on v9's slab path (K2 at q_n = 2, K3, K4), its converged share
   and PCr error, its cost against the plain path's within the
   reference's VARPRO bounds (the total <= 1.002x; >= 99.5 % of voxels
   <= 1.005x, beside a control: the plain path on data one ulp up),
   ms in turns with the fixed-g grid, the g-scan seeding and the LM with
   the override on and off, and the same grid fit timed on a Voigt
   version of the phantom (g = 0.5), where g can be identified;
   4p. ``fit_amares`` on the same array with that prior (K2, K3, K6b),
   again with planes staged by ``stage_device_fids`` (bit for bit), its
   residual cost against the plain path's within the same bounds, and its
   stage split (``XMT_FIT_STAGE_TIMERS``);
   4q. ``process_grid_planar_raw`` at ``PipelineConfig(zero_fill_to=2048)``
   defaults (differential evolution on the pivot row): its phases and ACME
   score beside the grid search's, and ms in turns with the grid search;
   4r. per-voxel DE (``autophase="all"``, ``ap_optimizer="de"``) on the full
   grid, its scores beside the per-voxel grid search's, and the DE search
   alone at voxel chunks of 2048-16384;
   4s. ``mrsi_pipeline`` on the labeled grid at ``PipelineConfig`` defaults
   (lb = 5, DE pivot) and with the grid search: one K1 launch a call, no
   plain version, spectra and phases bit for bit ``spectral_pipeline_
   planar_raw`` on the same planes, window and frequencies; ``gb=8``
   without autophase against ``zero_fill -> apodize_lg -> to_spectrum``
   at 1e-6 max|S|;
   4t. per-voxel ``mrsi_pipeline`` (grid search): one K1 and one K5 launch,
   held against the plain KernelSet's run by ACME score (x1.02 both ways);
   4u. the per-voxel grid search with the ``"newton"`` and ``"bfgs"``
   polishes against ``"gd"``: no K5 launch, phases in the box, every
   voxel's ACME within x1.02 + 1e-9 of gd's (the share within x1.001
   reported);
   4v. ``autophase(method="peak_minima"/"positivity", p0_only=True,
   peak_width=200)`` in single mode (grid and DE) and per voxel (grid):
   finite, no kernel launched; one ``optimizer="scipy"`` call on the
   pivot row, timed;
   4w. ``als_baseline_batched`` (CR, float64 on the card) on the 16 384 x
   2048 real spectra at lam 1e5, p 0.001, 10 iterations, against the CPU
   scan solver on 64 voxels spread over the grid at 1e-7 max|z|, and on
   float32 input (no NaN);
   4x. multi-coil k-space to maps: the bench FIDs times 8 seeded unit-RSS
   coil maps, to centered k-space (coil 8, kx 32, ky 32, kz 16, time 1024;
   complex64, 1 GiB) staged once as a tensor-payload ``XmrArray``; then
   ``kspace_to_image -> sense_combine`` with the true maps (the FIDs within
   1e-5 max|FID|), ``rss_reconstruct`` (|FID| at the same bar),
   ``estimate_sensitivities`` on time 0 (mean error < 0.05 in the interior),
   ``mrsi_pipeline`` (grid search) on the recon'd grid with one K1 launch
   (spectra within 1e-4 max|S| of 4s's turned onto this run's phases, the
   pivot row's ACME within x1.001 of 4s's), ``.xmr.fit_amares`` on it (K2,
   K3, K6b; converged >= 0.95, PCr median error <= 0.05, >= 99.5 % of voxels
   within 2e-3 + 0.1 CRLB of 4c's maps); BASELINE config 3 (8 x 256 x 256,
   ``tests/test_recon.py``'s phantom): RSS within 1e-5 of a float64 numpy
   recon, SENSE within 5 %, the adaptive combine within 2 % of RSS in the
   object; BASELINE config 1 (five simulated voxels) through the accessor
   Quick Start with its peak at 4.7 ppm; each recon step timed in turns and
   printed as the ``slice_12`` JSON line with the phase's peak GiB;
   4y. the voxel mesh on one card: ``process_grid_sharded`` over
   ``Mesh([cuda:0])`` and ``Mesh([cuda:0] * 4)`` (single pivot and per
   voxel) against the one-device program (spectra and phases bit for bit;
   K1, K4 and K5 once a shard; K2 and K3 the sums of each shard's fit run
   alone); ``lm_fit_batched_pallas_sharded`` at v8 and v10 over 4 shards
   against the single launch; ``fit_amares`` over 4 shards held to 4c's
   maps; ``serve_main --once`` serially and with ``--pipeline`` on 3 bench
   grids (the same records and ledger, the exit code their convergence
   implies, maps held to 4c's); ``fit_main`` on one grid and
   ``recon_main`` RSS and SENSE on config 3 against 4x's; one grid under
   ``runtime.profiling.trace``, whose trace names K1 and K2; printed as the
   ``slice_13`` JSON line;
   4z. the visualization layer: the bench grid as a CUDA payload through
   ``mrsi_pipeline`` (grid search; one K1, spectra held to 4s's) and
   ``.xmr.fit_amares`` (K2, K3, K6b; every voxel within 2e-3 + 0.1 CRLB of
   4c's maps), then the QC grid (16 panels) and trajectories of the
   centre column's fit, the waterfall and carpet of its spectra, and the
   phase, scroller and apodizer widgets, each from the card payload and a
   CPU copy: the drawn arrays equal a numpy computation from the same
   results (the QC spectra within 1e-5 of max|S| of a float64 FFT, the
   rest exactly), the same from both copies, at most one device-to-host
   copy per drawn array (4 for the QC grid), each widget's HTML holding
   its JS engine, ms in turns; where matplotlib or traitlets is missing,
   the figures' and widgets' host data (``visualization._host``) are
   checked instead; printed as the ``slice_14`` JSON line;
   4za. the planar matmul DFT (``ops/kernels/dft.py``, no kernel):
   ``dft_planar`` in float32 on the card at n = 13, 100, 2048, every
   variant, forward and inverse, within 5e-6 max|S| of numpy's float64 FFT
   and bit for bit the same with TF32 on; the emulated precisions
   (``"high"`` within 2^-16, ``"default"`` within 1e-2 and above 10x
   ``"highest"``); the bench grid through ``process_grid_planar_raw`` at
   ``dft_variant`` None, "pallas", "fused", "einsum", "flat", "block" and
   "full" (K1 exactly for the first two, never for the others; spectra
   turned onto None's phases within 5e-6 max|S|; the pivot row's ACME
   within x1.001; the fit within 2e-3 + 0.1 CRLB; the stage at None bit
   for bit one K1 call); the stacked layout with "pallas", and its
   ``ValueError`` with "einsum"; ``mrsi_pipeline`` at "fused" (no kernel)
   against 4s's, then ``.xmr.fit_amares`` against 4c's maps; each
   variant's spectral stage timed in turns with K1's; printed as the
   ``slice_16`` JSON line;
5. timing: median ms per single-pivot grid over synchronized grids, and
   voxels/s; the grid and its fit stage at every version in turns with
   v9; median ms of a per-voxel-autophased grid; median s of one
   ``fit_amares`` call at versions 9, 10 and 8; this slice's entry points
   in turns (``mrsi_pipeline`` with the grid search, DE and per voxel,
   the per-voxel grid search with each polish, the AsLS grid, the scipy
   call), printed as the ``slice_11`` JSON line.

``--profile-dir DIR`` adds a ``torch.profiler`` look at one grid of each
autophase mode and of the v10, v3, v8 and v7 fits: the device-busy share
on stdout
and kernel tables in ``DIR/profile*.txt``.  The
line before the card's name lists every kernel as JSON; the last line of
standard output is one JSON object with ``"ok": true`` and the device.
Without a CUDA device, or outside a checkout of the repo, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import base64
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path


# The g scan's candidates (fit_amares's g_scan="auto" ladder).
G_SCAN = (0.0, 0.2, 0.4, 0.6, 0.8)


def _free_g_csv(csv):
    """A prior table with every g freed to (0, 1) from an initial 0.1."""
    n = csv.splitlines()[0].count(",")
    out = csv.replace("g," + ",".join(["0"] * n), "g," + ",".join(["0.1"] * n))
    out = out.replace("g," + ",".join(["fixed"] * n),
                      "g," + ",".join(['"(0, 1)"'] * n))
    if out.count("0.1") < n or out.count('"(0, 1)"') != n:
        raise AssertionError("the prior's g rows are not in the expected form")
    return out


def _sync():
    import torch

    torch.cuda.synchronize()


_START = time.perf_counter()


def _phase(name):
    print(f"== {name} (at {time.perf_counter() - _START:.1f} s)", flush=True)


def _atol_text(atol):
    """A scalar atol as a number, a per-entry one as its range."""
    import torch

    if not isinstance(atol, torch.Tensor):
        return f"{atol:.3e}"
    return (f"{float(atol.min()):.3e}..{float(atol.max()):.3e} per entry")


def _err_over_limit(err, lim):
    """``err / lim``, but 0 wherever the error is 0 (also against a zero
    limit), so that a nonzero error against a zero limit reads inf."""
    import torch

    return torch.where(err == 0, torch.zeros_like(err), err / lim)


def _assert_close(name, got, ref, rtol, atol, mask=None):
    """``|got - ref| <= atol + rtol*|ref|`` elementwise (NaN == NaN), with
    ``atol`` a number or a tensor of ``ref``'s shape; prints the error
    beside the limit and returns the max abs error."""
    import torch

    got = got.double()
    ref = ref.double()
    atol = atol.double() if isinstance(atol, torch.Tensor) else atol
    if mask is not None:
        got, ref = got[mask], ref[mask]
        atol = atol[mask] if isinstance(atol, torch.Tensor) else atol
    nan_g, nan_r = torch.isnan(got), torch.isnan(ref)
    if not torch.equal(nan_g, nan_r):
        raise AssertionError(f"{name}: NaN pattern differs")
    fin = ~nan_r
    err = (got[fin] - ref[fin]).abs()
    lim = (atol[fin] if isinstance(atol, torch.Tensor) else atol) \
        + rtol * ref[fin].abs()
    worst = float(_err_over_limit(err, lim).max()) if err.numel() else 0.0
    max_err = float(err.max()) if err.numel() else 0.0
    print(f"   {name}: max|err| {max_err:.3e}  worst err/limit {worst:.3f} "
          f"(rtol {rtol:g}, atol {_atol_text(atol)})", flush=True)
    if not worst <= 1.0:
        raise AssertionError(f"{name}: error above tolerance ({worst:.3f}x)")
    return max_err


def _gram_atols(h_ref, cost_ref, scale):
    """Per-entry atols of a Gauss-Newton H = J J^T and g = J r (cost = r.r):
    ``scale*sqrt(|H_ii H_jj|)`` and ``scale*sqrt(|H_ii| cost)``, the
    Cauchy-Schwarz bounds of |H_ij| and |g_i| (and of the rounding of their
    sums) scaled down, so that each row is held at its own size."""
    import torch

    d = torch.diagonal(h_ref, dim1=-2, dim2=-1).double().abs().sqrt()
    return (scale * d[..., :, None] * d[..., None, :],
            scale * d * cost_ref.double().abs().sqrt()[..., None])


def _row_blocks(tag, rows, got, ref, atol, rtol):
    """Prints the worst err/limit of H's rows of each parameter kind (the
    physical row index mod 5), so each block shows its own margin."""
    import torch

    kinds = ("amplitude", "shift", "linewidth", "phase", "g")
    err = (got.double() - ref.double()).abs()
    ratio = _err_over_limit(err, atol + rtol * ref.double().abs())
    parts = []
    for c, kname in enumerate(kinds):
        idx = [i for i, r in enumerate(rows) if r % 5 == c]
        if idx:
            sel = torch.as_tensor(idx, device=ratio.device)
            parts.append(f"{kname} {float(ratio[:, sel].max()):.3f}")
    print(f"   {tag} H rows, worst err/limit by kind: {', '.join(parts)}",
          flush=True)


def _share_within(name, got, ref, rtol, atol, min_share):
    """Share of voxels (rows) whose every entry is within
    ``atol + rtol*|ref|`` (``atol`` a number or a tensor of ``ref``'s
    shape); raises below ``min_share``."""
    import torch

    atol = atol.double() if isinstance(atol, torch.Tensor) else atol
    ok = ((got.double() - ref.double()).abs()
          <= atol + rtol * ref.double().abs()).all(-1)
    share = float(ok.double().mean())
    print(f"   {name}: {share:.5f} of voxels within rtol {rtol:g} / atol "
          f"{_atol_text(atol)} (limit >= {min_share})", flush=True)
    if share < min_share:
        raise AssertionError(f"{name}: too few voxels within tolerance")
    return share


def _cost_not_worse(name, cost, cost_ref, min_share, per_voxel=1.005,
                    total=1.002):
    """Per-voxel cost against a reference path's, with the reference's
    VARPRO bounds (``TestVarpro``): the sum at most ``total`` x, and at
    least ``min_share`` of the voxels at most ``per_voxel`` x (every voxel
    in the reference's test; here unfinished descents drift apart on a few,
    which the one-ulp control of phases 4o/4p measures).  Raises otherwise;
    ``min_share=None`` only reports.  Returns (share within, max ratio,
    total ratio, reverse share within, reverse max ratio)."""
    import torch

    c = torch.as_tensor(cost).double().reshape(-1)
    r = torch.as_tensor(cost_ref).double().reshape(-1).to(c.device)
    ratio = c / r
    share = float((ratio <= per_voxel).double().mean())
    worst, tot = float(ratio.max()), float(c.sum() / r.sum())
    back = float((r / c <= per_voxel).double().mean())
    top = torch.topk(ratio, min(3, ratio.numel()))
    gated = min_share is not None
    print(f"   {name}: {share:.5f} of voxels within x{per_voxel} "
          + (f"(limit >= {min_share})" if gated else "(reported)")
          + f", max ratio {worst:.6f}; total {tot:.8f} "
          + (f"(limit <= {total})" if gated else "(reported)")
          + f"; the other way {back:.5f} within, max {float((r / c).max()):.6f}; "
          "worst voxels (index ratio cost ref-cost) " + "; ".join(
              f"{int(i)} {float(v):.6f} {float(c[i]):.6e} {float(r[i]):.6e}"
              for v, i in zip(top.values, top.indices)), flush=True)
    if gated and not (share >= min_share and tot <= total):
        raise AssertionError(f"{name}: the cost is above the reference "
                             "path's bounds")
    return share, worst, tot, back, float((r / c).max())


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


# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 (non-tensor) FLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# and float64 on the tensor cores (the matmul DFT's contractions).
PEAK_FP64_TENSOR_FLOPS = 67e12


def _bound(nbytes, flops):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the fp32 rate, in ms, and which
    one bounds it."""
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    t_ops = 1e3 * flops / PEAK_FP32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _ptxas_summary(log, source, *name_parts):
    """ptxas's registers and spills of the kernels of ``source`` whose
    mangled name contains every one of ``name_parts``, from the build's
    ptxas log."""
    if not log.exists():
        raise AssertionError(f"no ptxas log at {log}")
    text = log.read_text().split(f"== {source}\n", 1)[1].split("\n== ", 1)[0]
    lines = text.splitlines()
    out = []
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and all(
                part in ln for part in name_parts):
            out += [x.split(" : ", 1)[-1].strip() for x in lines[i + 1:i + 5]
                    if "registers" in x or "spill" in x]
    if not out:
        raise AssertionError(f"{source}: no ptxas lines for {name_parts}")
    return " / ".join(out)


def _same_bits(a, b):
    """Equal bit for bit: NaN at the same places, every other float32 entry
    with the same bits (the sign of a zero included)."""
    import torch

    nan = torch.isnan(b)
    return (a.shape == b.shape and torch.equal(torch.isnan(a), nan)
            and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def _wrapped(a):
    """Phase difference in degrees wrapped into [-180, 180)."""
    import torch

    return torch.remainder(a + 180.0, 360.0) - 180.0


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
    import dataclasses

    import numpy as np

    from xmris_tpu_torch import bench_inputs as bi
    from xmris_tpu_torch import simulate_fid
    from xmris_tpu_torch.core.array import Coord, XmrArray
    from xmris_tpu_torch.fitting.amares import (
        fit_amares,
        g_seed_plan,
        seed_grid,
        seed_plan,
        seeded_fit_grid_raw,
        stage_device_fids,
        template_optimum,
    )
    from xmris_tpu_torch.fitting.lm import (
        _lm_fit_batched_pallas_impl,
        crlb_batched_planar,
        hashable_pmap,
        lm_fit_batched_pallas,
        lorentzian_env_flags,
        normal_eq_plan,
        slab_to_bff,
    )
    from xmris_tpu_torch.fitting.prior import prior_from_csv_text
    from xmris_tpu_torch.ops import kernels as K
    from xmris_tpu_torch.ops.baseline import als_baseline_batched
    from xmris_tpu_torch.ops.bounds import (
        expand_params_batched,
        internal_to_external_torch,
    )
    from xmris_tpu_torch.ops.fid import apodize_lg, to_spectrum, zero_fill
    from xmris_tpu_torch.ops.kernels import (
        _build,
        acme_cuda,
        dft_cuda,
        lm_cuda,
        lm_jac_cuda,
        lm_loop_cuda,
        spd,
    )
    from xmris_tpu_torch.ops.phasing import (
        POLISH_ITERS,
        _de_phase_search,
        _grid_phase_search,
        _phased_real_planar,
        acme_score_raw,
        autophase,
        de_chunk_rows,
        phase_factor_raw,
    )
    from xmris_tpu_torch.parallel.pipeline import (
        PipelineConfig,
        mrsi_pipeline,
        spectral_constants,
    )
    from xmris_tpu_torch.parallel.planar_pipeline import (
        spectral_pipeline_planar_raw,
    )
    from xmris_tpu_torch.parallel.process import (
        grid_inputs_from_numpy,
        process_grid_planar_raw,
    )
    from xmris_tpu_torch.recon import (
        estimate_sensitivities,
        kspace_to_image,
        rss_reconstruct,
        sense_combine,
        sense_reconstruct,
    )
    from xmris_tpu_torch.recon.sense import adaptive_combine_planar_raw
    from xmris_tpu_torch.interop.io import load_dataset_npz, load_npz, save_npz
    from xmris_tpu_torch.parallel.fit import lm_fit_batched_pallas_sharded
    from xmris_tpu_torch.parallel.mesh import Mesh
    from xmris_tpu_torch.parallel.process import process_grid_sharded
    from xmris_tpu_torch.runtime import cli
    from xmris_tpu_torch.runtime.profiling import Timings, stage_timer, trace

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
    log = _build.BUILD_DIR / "ptxas.log"
    for tag, src in (("K2", "lm_v9.cu"), ("K9", "lm_v8.cu")):
        print(f"   {tag} ({src}, K=5, q_n=1): "
              f"{_ptxas_summary(log, src, 'normal_eq_warp_kernelILi5ELi1E')}",
              flush=True)
    for tag, name, layout in (
            ("K3", "spd_solve_damped_kernelILi20E", "SlabTile"),
            ("K4", "spd_inverse_diag_kernelILi20E", "SlabTile"),
            ("K6a", "spd_solve_damped_kernelILi20E", "Dense"),
            ("K6b", "spd_inverse_diag_kernelILi20E", "Dense")):
        print(f"   {tag} (spd.cu, F=20): "
              f"{_ptxas_summary(log, 'spd.cu', name, layout)}", flush=True)
    print(f"   K8 (lm_v10.cu): {_ptxas_summary(log, 'lm_v10.cu', 'lm_loop')}",
          flush=True)

    # ---- inputs: the bench phantom and prior ----
    fids, weight, freqs = bi.make_inputs()
    b = fids.shape[0]
    pk = prior_from_csv_text(bi.PK_CSV, "bench PK_CSV")
    ps = hashable_pmap(pk.pmap)
    amp_slots, ls_plan = seed_plan(pk)
    t_np = (np.arange(bi.N_TIME) / bi.SW).astype(np.float32)
    x_template = template_optimum(fids, pk, torch.from_numpy(t_np).to(dev),
                                  bi.MHZ)
    args = grid_inputs_from_numpy(fids, weight, freqs, t_np, x_template, pk,
                                  dev)
    re, im, w_d, f_d, t_d, xt_d, lower, upper, kind = args
    n_free = pk.n_free
    cfg = PipelineConfig(zero_fill_to=bi.ZERO_FILL, autophase="single",
                         ap_optimizer="grid", spec_layout="stacked")
    cfg_all = PipelineConfig(zero_fill_to=bi.ZERO_FILL, autophase="all",
                             ap_optimizer="grid", spec_layout="flat")
    fit_kw = dict(cfg=cfg, pmap_static=ps, mhz=bi.MHZ, amp_slots=amp_slots,
                  ls_plan=ls_plan, max_iter=24, plateau_streak=3,
                  uniform_t_ok=True)
    fit_kw_all = dict(fit_kw, cfg=cfg_all)
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
    if dft_cuda.route(bi.N_TIME, bi.ZERO_FILL) != "fft":
        raise AssertionError("K1: the bench shape does not take the FFT route")
    # K1's other kernel, the split, on a length the FFT does not take.
    n_split = (768, 1536)
    if dft_cuda.route(*n_split) != "split":
        raise AssertionError("K1: 768 -> 1536 does not take the split route")
    g_split = torch.Generator(device=dev).manual_seed(0)
    xs = [torch.randn((4096, n_split[0]), device=dev, generator=g_split)
          for _ in range(2)]
    ws = torch.rand(n_split[0], device=dev, generator=g_split)
    ks_s = dft_cuda.spectrum(*xs, n_split[1], window=ws, with_maxmag=True,
                             stacked_out=True)
    kp_s = dft_cuda.spectrum_plain(*xs, n_split[1], window=ws,
                                   with_maxmag=True, stacked_out=True)
    _sync()
    scale_s = float(torch.maximum(kp_s[0].abs().max(), kp_s[1].abs().max()))
    e1 = max(e1,
             _assert_close("K1 split route (768 -> 1536) re", ks_s[0], kp_s[0],
                           0.0, 1e-6 * scale_s),
             _assert_close("K1 split route (768 -> 1536) im", ks_s[1], kp_s[1],
                           0.0, 1e-6 * scale_s))
    if not torch.equal(ks_s[3].long(), kp_s[3].long()):
        raise AssertionError("K1 split route: per-voxel argmax indices differ")
    print(f"   K1 split route argmax indices identical; split kernel "
          f"{_time_ms(lambda: dft_cuda.spectrum(*xs, n_split[1], window=ws, with_maxmag=True), 10):.4f}"
          f" ms for 4096 voxels at 768 -> 1536", flush=True)
    del xs, ws, ks_s, kp_s
    # A zero-fill without a split: 500 -> 1024 on K1's FFT route, and
    # 1000 -> 1500 on the dense route (a matmul, not K1), each against the
    # plain version; the dense route counts apart from K1.
    for (n_a, n_b), want in (((500, 1024), "fft"), ((1000, 1500), "dense")):
        if dft_cuda.route(n_a, n_b) != want or dft_cuda.pallas_split_ok(n_a, n_b):
            raise AssertionError(f"{n_a} -> {n_b} does not take the {want} route")
        xs = [torch.randn((4096, n_a), device=dev, generator=g_split)
              for _ in range(2)]
        ws = torch.rand(n_a, device=dev, generator=g_split)
        K.reset_counters()
        ks_s = dft_cuda.spectrum(*xs, n_b, window=ws, with_maxmag=True)
        _sync()
        counts = K.counters()["launches"]
        kp_s = dft_cuda.spectrum_plain(*xs, n_b, window=ws, with_maxmag=True)
        _sync()
        if (counts["spectrum"], counts["spectrum_dense"]) != (
                (1, 0) if want == "fft" else (0, 1)):
            raise AssertionError(f"{n_a} -> {n_b}: launches {counts}")
        scale_s = float(torch.maximum(kp_s[0].abs().max(), kp_s[1].abs().max()))
        err = max(_assert_close(f"{want} route ({n_a} -> {n_b}) re", ks_s[0],
                                kp_s[0], 0.0, 1e-6 * scale_s),
                  _assert_close(f"{want} route ({n_a} -> {n_b}) im", ks_s[1],
                                kp_s[1], 0.0, 1e-6 * scale_s))
        if not torch.equal(ks_s[3].long(), kp_s[3].long()):
            raise AssertionError(f"{want} route: per-voxel argmax indices differ")
        if want == "fft":
            e1 = max(e1, err)
        print(f"   {want} route ({n_a} -> {n_b}, 4096 voxels): argmax identical, "
              f"{_time_ms(lambda: dft_cuda.spectrum(*xs, n_b, window=ws, with_maxmag=True), 10):.4f}"
              f" ms", flush=True)
        del xs, ws, ks_s, kp_s
    z_win = torch.complex(re * win, im * win)
    n_in, n_out = bi.N_TIME, bi.ZERO_FILL
    report["spectrum"] = dict(
        err=e1,
        ms=_time_ms(lambda: dft_cuda.spectrum(
            re, im, bi.ZERO_FILL, window=win, with_maxmag=True,
            stacked_out=True), 10),
        plain_ms=_time_ms(lambda: dft_cuda.spectrum_plain(
            re, im, bi.ZERO_FILL, window=win, with_maxmag=True,
            stacked_out=True), 5),
        # One call of the same transform on the windowed input (cuFFT).
        library_ms=_time_ms(lambda: torch.fft.fft(
            z_win, n=n_out, dim=-1, norm="ortho"), 10),
        # Planes in, planes + per-voxel peak out; an FFT's 5 n log2 n.
        bound=_bound(b * (8 * n_in + 8 * n_out + 8) + 4 * n_in,
                     b * 5 * n_out * np.log2(n_out)),
    )
    del z_win

    u0 = seed_grid(re, im, t_d, xt_d, lower, upper, kind, pmap_static=ps,
                   mhz=bi.MHZ, amp_slots=amp_slots, ls_plan=ls_plan)
    x0, dxdu = internal_to_external_torch(u0, lower, upper, kind)
    grids = expand_params_batched(x0, ps).contiguous()
    dxdu = dxdu.contiguous()
    plan = normal_eq_plan(ps, n_free, bi.MHZ, True)
    c_k, g_k, h_k = lm_cuda.eq6_normal_equations(grids, re, im, t_d, dxdu, plan)
    c_p, g_p, h_p = lm_cuda.eq6_normal_equations_plain(grids, re, im, t_d,
                                                       dxdu, plan)
    _sync()
    _assert_close("K2 cost", c_k, c_p, 1e-5, 0.0)
    # Each entry held at its own rows' size, as for K7 below.
    h_atol, g_atol = _gram_atols(slab_to_bff(h_p, n_free), c_p, 1e-3)
    e2g = _assert_close("K2 g", g_k, g_p, 1e-4, g_atol)
    e2h = _assert_close("K2 H", slab_to_bff(h_k, n_free),
                        slab_to_bff(h_p, n_free), 1e-4, h_atol)
    del h_atol, g_atol
    kp_, qn = pk.n_peaks, plan.q_n
    # Per (voxel, t): the model (~10 per peak), residual and cost (6),
    # one complex product per peak pair with 2*q_n+1 t-power moments
    # (6 + 4 each) and the gradient moments per peak (6 + 4 (q_n+1)).
    k2_ops = n_in * (10 * kp_ + 6 + kp_ * (kp_ + 1) / 2 * (6 + 4 * (2 * qn + 1))
                     + kp_ * (6 + 4 * (qn + 1)))
    report["eq6_normal_eq_v9"] = dict(
        err=max(e2g, e2h),
        ms=_time_ms(lambda: lm_cuda.eq6_normal_equations(
            grids, re, im, t_d, dxdu, plan), 10),
        plain_ms=_time_ms(lambda: lm_cuda.eq6_normal_equations_plain(
            grids, re, im, t_d, dxdu, plan), 3),
        library_ms=None,
        bound=_bound(
            b * 4 * (kp_ * 5 + 2 * n_in + n_free + 1 + n_free + n_free ** 2)
            + 4 * n_in,
            b * k2_ops,
        ),
    )

    # K2's accept gate: cost_prev just above the cost on even voxels (they
    # improve) and just below it on odd ones (rejected: no moments, g, H).
    factor = torch.where(torch.arange(b, device=dev) % 2 == 0, 1.01, 0.99)
    c_prev = (c_k * factor).contiguous()
    c_g, g_g, h_g = lm_cuda.eq6_normal_equations(grids, re, im, t_d, dxdu, plan,
                                                 cost_prev=c_prev)
    _sync()
    better = c_g < c_prev
    if not (torch.equal(c_g, c_k) and torch.equal(g_g[better], g_k[better])
            and torch.equal(h_g[:, better], h_k[:, better])):
        raise AssertionError("K2 with the accept gate differs from K2")
    print(f"   K2 gated: cost bit for bit on all {b} voxels, g and H bit for "
          f"bit on the {int(better.sum())} improving ones")
    del c_g, g_g, h_g, c_prev

    planted = torch.tensor([5, 777, b - 3], device=dev)
    h_sp = h_k.clone()
    h_sp[0, planted] = -1.0  # H[0, 0] < 0: not SPD
    lam = torch.full((b,), 1e-3, device=dev)
    bad = torch.zeros(b, dtype=torch.bool, device=dev)
    bad[planted] = True
    h_dense = slab_to_bff(h_sp, n_free)
    d_k = spd.spd_solve_damped(h_sp, g_k, lam)
    d_p = spd.spd_solve_damped_plain(h_sp, g_k, lam)
    i_k = spd.spd_inverse_diag(h_sp, 1e-12)
    i_p = spd.spd_inverse_diag_plain(h_sp, 1e-12)
    j_k = spd.spd_inverse_diag_dense(h_dense)
    j_p = spd.spd_inverse_diag_dense_plain(h_dense)
    a_k = spd.spd_solve_damped_dense(h_dense, g_k, lam)
    a_p = spd.spd_solve_damped_dense_plain(h_dense, g_k, lam)
    _sync()
    for name, out in (("K3", d_k), ("K4", i_k), ("K6a", a_k), ("K6b", j_k)):
        rows_nan = torch.isnan(out).all(1)
        if not torch.equal(rows_nan, bad) or torch.isnan(out[~bad]).any():
            raise AssertionError(f"{name}: NaN rows are not the planted ones")
    print("   K3/K4/K6a/K6b NaN rows exactly at the planted non-SPD voxels")
    i0_k = spd.spd_inverse_diag(h_sp, 0.0)
    i0_p = spd.spd_inverse_diag_plain(h_sp, 0.0)
    _sync()
    for name, got, ref in (
            ("K3 against its plain version", d_k, d_p),
            ("K4 (ridge 1e-12) against its plain version", i_k, i_p),
            ("K4 (no ridge) against its plain version", i0_k, i0_p),
            ("K6a against its plain version", a_k, a_p),
            ("K6b against its plain version", j_k, j_p),
            ("K3 against K6a", d_k, a_k),
            ("K4 (no ridge) against K6b", i0_k, j_k)):
        if not _same_bits(got, ref):
            raise AssertionError(f"{name}: not bit for bit")
        print(f"   {name}: bit for bit (NaN rows included)")
    del i0_k, i0_p
    e6a = _assert_close("K6a solve (dense)", a_k, a_p, 2e-6, 1e-7, mask=~bad)
    e3 = _assert_close("K3 solve", d_k, d_p, 2e-6, 1e-7, mask=~bad)
    e4 = _assert_close("K4 inverse diag", i_k, i_p, 2e-4, 0.0, mask=~bad)
    e6 = _assert_close("K6b inverse diag (dense)", j_k, j_p, 2e-4, 0.0,
                       mask=~bad)
    h_bff = slab_to_bff(h_k, n_free)
    spd_flops = b * n_free ** 3 / 3.0
    # Each SPD kernel reads only the upper triangle of a voxel's H.
    tri = n_free * (n_free + 1) // 2
    report["spd_solve_damped"] = dict(
        err=e3,
        ms=_time_ms(lambda: spd.spd_solve_damped(h_k, g_k, lam), 10),
        plain_ms=_time_ms(lambda: spd.spd_solve_damped_plain(h_k, g_k, lam), 3),
        library_ms=None,
        bound=_bound(b * 4 * (tri + 2 * n_free + 1),
                     spd_flops + b * 2 * n_free ** 2),
    )
    report["spd_inverse_diag"] = dict(
        err=e4,
        ms=_time_ms(lambda: spd.spd_inverse_diag(h_k, 1e-12), 10),
        plain_ms=_time_ms(lambda: spd.spd_inverse_diag_plain(h_k, 1e-12), 3),
        library_ms=None,
        bound=_bound(b * 4 * (tri + n_free), 2 * spd_flops),
    )
    report["spd_inverse_diag_dense"] = dict(
        err=e6,
        ms=_time_ms(lambda: spd.spd_inverse_diag_dense(h_bff), 10),
        plain_ms=_time_ms(lambda: spd.spd_inverse_diag_dense_plain(h_bff), 3),
        library_ms=None,
        bound=_bound(b * 4 * (tri + n_free), 2 * spd_flops),
    )
    report["spd_solve_damped_dense"] = dict(
        err=e6a,
        ms=_time_ms(lambda: spd.spd_solve_damped_dense(h_bff, g_k, lam), 10),
        plain_ms=_time_ms(
            lambda: spd.spd_solve_damped_dense_plain(h_bff, g_k, lam), 3),
        library_ms=None,
        bound=_bound(b * 4 * (tri + 2 * n_free + 1),
                     spd_flops + b * 2 * n_free ** 2),
    )
    # Yardstick, not a single call (library_ms stays null): the cuSOLVER
    # composition of the same functions, the damping done beforehand.
    diag = torch.diagonal(h_bff, dim1=1, dim2=2)
    damped = h_bff.clone()
    torch.diagonal(damped, dim1=1, dim2=2).copy_(
        diag + lam[:, None] * torch.clamp(diag, min=1e-12) + 1e-12)

    def chol_solve():
        fac, _ = torch.linalg.cholesky_ex(damped)
        return torch.cholesky_solve(g_k[:, :, None], fac)

    def chol_inverse_diag():
        fac, _ = torch.linalg.cholesky_ex(h_bff)
        return torch.diagonal(torch.cholesky_inverse(fac), dim1=1, dim2=2)

    composition = {"K6a": _time_ms(chol_solve, 10),
                   "K6b": _time_ms(chol_inverse_diag, 10)}
    print(f"   cuSOLVER composition (cholesky_ex + cholesky_solve; "
          f"cholesky_ex + cholesky_inverse + diagonal) at B={b}, F={n_free}: "
          f"{composition['K6a']:.4f} / {composition['K6b']:.4f} ms; "
          f"K6a {report['spd_solve_damped_dense']['ms']:.4f} ms, K6b "
          f"{report['spd_inverse_diag_dense']['ms']:.4f} ms", flush=True)
    del damped, diag
    del c_p, g_p, h_p, h_sp, h_dense, d_k, d_p, i_k, i_p, j_k, j_p, h_bff
    del a_k, a_p

    # The explicit-Jacobian family at the seeded bench grid, in physical
    # space: K7, K13 and K14 (every physical row, one kernel), K12 and K11
    # (the prior's active rows, K11 unmasked: its first launch in the LM),
    # K10 (K11 on the block-factored basis) and K9 (the three moments).
    active = tuple(plan.active)
    all_rows = tuple(range(5 * kp_))
    flags = lorentzian_env_flags(ps)
    jargs = (grids, re, im, t_d, kp_, bi.MHZ)
    jac = {
        "eq6_normal_eq_v3": ("K7", all_rows,
                             lambda: lm_jac_cuda.eq6_normal_equations_v3(*jargs),
                             lambda: lm_jac_cuda.eq6_normal_equations_v3_plain(
                                 *jargs)),
        "eq6_normal_eq_v2": ("K13", all_rows,
                             lambda: lm_jac_cuda.eq6_normal_equations_v2(*jargs),
                             lambda: lm_jac_cuda.eq6_normal_equations_v2_plain(
                                 *jargs)),
        "eq6_normal_eq_v1": ("K14", all_rows,
                             lambda: lm_jac_cuda.eq6_normal_equations_v1(*jargs),
                             lambda: lm_jac_cuda.eq6_normal_equations_v1_plain(
                                 *jargs)),
        "eq6_normal_eq_v5": ("K12", active,
                             lambda: lm_jac_cuda.eq6_normal_equations_v5(
                                 *jargs, active),
                             lambda: lm_jac_cuda.eq6_normal_equations_v5_plain(
                                 *jargs, active)),
        "eq6_normal_eq_v6": ("K11", active,
                             lambda: lm_jac_cuda.eq6_normal_equations_v6(
                                 *jargs, active),
                             lambda: lm_jac_cuda.eq6_normal_equations_v6_plain(
                                 *jargs, active)),
        "eq6_normal_eq_v7": ("K10", active,
                             lambda: lm_jac_cuda.eq6_normal_equations_v7(
                                 *jargs, active, flags, validate=False),
                             lambda: lm_jac_cuda.eq6_normal_equations_v7_plain(
                                 *jargs, active, flags, validate=False)),
        "eq6_normal_eq_v8": ("K9", active,
                             lambda: lm_cuda.eq6_normal_equations_v8(
                                 *jargs, active, validate=False),
                             lambda: lm_cuda.eq6_normal_equations_v8_plain(
                                 *jargs, active, validate=False)),
    }
    jac_out = {}
    for name, (tag, rows, kern, plain) in jac.items():
        ck, gk, hk = kern()
        cp, gp, hp = plain()
        _sync()
        _assert_close(f"{tag} cost", ck, cp, 1e-5, 0.0)
        # The rows of H span orders of magnitude (shifts ~1e6, phases ~1):
        # each entry is held at its own rows' size, and each row block of H
        # is reported on its own.
        h_atol, g_atol = _gram_atols(hp, cp, 1e-3)
        err = max(_assert_close(f"{tag} g", gk, gp, 1e-4, g_atol),
                  _assert_close(f"{tag} H", hk, hp, 1e-4, h_atol))
        _row_blocks(tag, rows, hk, hp, h_atol, 1e-4)
        del cp, gp, hp, h_atol, g_atol
        n_r = len(rows)
        jac_out[name] = (ck, gk, hk)
        if name == "eq6_normal_eq_v8":
            # K2's work with q_n = 1 on the direct basis (~30 operations
            # per peak and sample: an exp, a sincos, the products), with
            # an identity fold.
            ops = n_in * (30 * kp_ + 6 + kp_ * (kp_ + 1) / 2 * (6 + 4 * 3)
                          + kp_ * (6 + 4 * 2))
        else:
            # Per (voxel, t): the bases (~10 per peak; ~6 from K10's
            # tables), model and residual (6), a Jacobian row (4 each) and
            # 2 multiply-adds for each upper-triangle H entry and g entry.
            per_peak = 6 if name == "eq6_normal_eq_v7" else 10
            ops = n_in * (per_peak * kp_ + 6 + 4 * n_r
                          + 4 * (n_r * (n_r + 1) / 2 + n_r))
        report[name] = dict(
            err=err,
            ms=_time_ms(kern, 10),
            plain_ms=_time_ms(plain, 1, warmup=1),
            library_ms=None,
            bound=_bound(
                b * 4 * (5 * kp_ + 2 * n_in + 1 + n_r + n_r * n_r) + 4 * n_in,
                b * ops),
        )
    sel = list(active)
    c3, g3, h3 = jac_out["eq6_normal_eq_v3"]
    for name in ("eq6_normal_eq_v2", "eq6_normal_eq_v1"):
        if not all(torch.equal(x, y) for x, y in zip(jac_out[name], (c3, g3, h3))):
            raise AssertionError(f"{jac[name][0]} differs from K7")
    print("   K13 and K14 equal K7, bit for bit")
    c5, g5, h5 = jac_out["eq6_normal_eq_v5"]
    same = (torch.equal(c5, c3) and torch.equal(g5, g3[:, sel])
            and torch.equal(h5, h3[:, sel][:, :, sel]))
    if not same:
        raise AssertionError("K12 differs from K7's active rows")
    print("   K12 equals K7 on K7's active rows, bit for bit")
    if not all(torch.equal(x, y) for x, y in
               zip(jac_out["eq6_normal_eq_v6"], (c5, g5, h5))):
        raise AssertionError("unmasked K11 differs from K12")
    keep = torch.arange(b, device=dev) % 2 == 0
    part = lm_jac_cuda.eq6_normal_equations_v6(*jargs, active, voxel_mask=keep)
    _sync()
    if not all(torch.equal(x[keep], y[keep]) for x, y in zip(part, (c5, g5, h5))):
        raise AssertionError("K11 differs from K12 on the voxels it keeps")
    print(f"   K11 equals K12 bit for bit, unmasked and on the "
          f"{int(keep.sum())} voxels its mask keeps")
    del part
    # K10's factored basis is another rounding of K11's: per entry.
    c6, g6, h6 = jac_out["eq6_normal_eq_v6"]
    h_atol, g_atol = _gram_atols(h6, c6, 1e-3)
    c7, g7, h7 = jac_out["eq6_normal_eq_v7"]
    _assert_close("K10 cost vs K11", c7, c6, 1e-5, 0.0)
    _assert_close("K10 g vs K11", g7, g6, 1e-4, g_atol)
    _assert_close("K10 H vs K11", h7, h6, 1e-4, h_atol)
    _row_blocks("K10 vs K11", active, h7, h6, h_atol, 1e-4)
    del jac_out, c3, g3, h3, c5, g5, h5, c6, g6, h6, c7, g7, h7, h_atol, g_atol

    # K8: the whole LM of the seeded bench grid, against its plain twin.
    loop_args = (u0, re, im, t_d, lower, upper, kind, plan, ps)
    k8 = lm_loop_cuda.lm_loop_v10(*loop_args, max_iter=24, with_trips=True)
    p8 = lm_loop_cuda.lm_loop_v10_plain(*loop_args, max_iter=24,
                                        with_trips=True)
    _sync()
    x_k8 = internal_to_external_torch(k8[0], lower, upper, kind)[0]
    x_p8 = internal_to_external_torch(p8[0], lower, upper, kind)[0]
    if not (bool(k8[3].all()) and bool(p8[3].all())):
        raise AssertionError("K8: voxels left undone")
    bits = float(((k8[0] == p8[0]).all(1) & (k8[1] == p8[1])).double().mean())
    same_acc = float((k8[2] == p8[2]).double().mean())
    print(f"   K8 vs plain: {bits:.5f} of voxels bit identical (u and cost), "
          f"{same_acc:.5f} with equal accepted steps; evaluations "
          f"{int(k8[5].sum())} (kernel) / {int(p8[5].sum())} (plain)")
    # An accept test turns the evaluation's last-bit differences into other
    # stopping points on a few voxels: held per voxel, by share.
    _share_within("K8 x", x_k8, x_p8, 1e-4, 1e-4, 0.99)
    _share_within("K8 cost", k8[1][:, None], p8[1][:, None], 1e-5, 0.0, 0.99)
    _share_within("K8 H", k8[4].reshape(b, -1), p8[4].reshape(b, -1), 1e-3,
                  _gram_atols(p8[4], p8[1], 1e-4)[0].reshape(b, -1), 0.99)
    n_eval = int(k8[5].sum())
    report["lm_loop_v10"] = dict(
        err=float((x_k8 - x_p8).abs().max()),
        ms=_time_ms(lambda: lm_loop_cuda.lm_loop_v10(*loop_args, max_iter=24),
                    3),
        plain_ms=_time_ms(lambda: lm_loop_cuda.lm_loop_v10_plain(
            *loop_args, max_iter=24), 1, warmup=1),
        library_ms=None,
        # FIDs and seed read once, u, cost, counts and H written once; per
        # evaluation this run made, K2's work and one F^3/3 factorization
        # with its two substitutions.
        bound=_bound(
            b * (8 * n_in + 4 * n_free * 2 + 9 + 4 * n_free ** 2) + 4 * n_in,
            n_eval * (k2_ops + n_free ** 3 / 3 + 2 * n_free ** 2)),
    )
    del k8, p8, x_k8, x_p8

    # K5 on the unphased flat bench spectra, each voxel's own pivot.
    sr, si, _, mi = dft_cuda.spectrum(re, im, bi.ZERO_FILL, window=win,
                                      with_maxmag=True)
    piv = f_d[mi.long()]
    x_range = float(f_d[-1] - f_d[0])
    rng = np.random.default_rng(0)
    p_rand = torch.as_tensor(np.stack([
        rng.uniform(-150, 150, b), rng.uniform(-3000, 3000, b)], 1
    ).astype(np.float32), device=dev)
    e5 = 0.0
    for p0_only in (False, True):
        tag = "p0" if p0_only else "p0+p1"
        kw = dict(n_iter=0, p0_only=p0_only, with_grad=True)
        _, fk, gk = acme_cuda.acme_polish(sr, si, f_d, piv, p_rand, x_range, **kw)
        _, fp, gp = acme_cuda.acme_polish_plain(sr, si, f_d, piv, p_rand,
                                                x_range, **kw)
        _sync()
        e5 = max(e5, _assert_close(f"K5 score, one evaluation ({tag})", fk, fp,
                                   1e-5, 0.0, mask=torch.isfinite(fp)))
        e5 = max(e5, _assert_close(f"K5 gradient, one evaluation ({tag})", gk,
                                   gp, 1e-5, 1e-7 * float(gp.abs().max())))
    # The whole 40-step polish from the grid scan's seeds (the scan with a
    # polish that returns its seeds).
    seeds_only = dataclasses.replace(K.PLAIN,
                                     acme_polish=lambda *a, **k: (a[4], None))
    for p0_only in (False, True):
        tag = "p0" if p0_only else "p0+p1"
        seed = _grid_phase_search(sr, si, f_d, x_range, piv, p0_only,
                                  polish_optimizer="fused", kernels=seeds_only)
        pk_, fk = acme_cuda.acme_polish(sr, si, f_d, piv, seed, x_range,
                                        p0_only=p0_only)
        pp_, fp = acme_cuda.acme_polish_plain(sr, si, f_d, piv, seed, x_range,
                                              p0_only=p0_only)
        _sync()
        _scores_both_ways(f"K5 polish scores ({tag})", fk, fp)
        dp = torch.stack([_wrapped(pk_[:, 0] - pp_[:, 0]),
                          pk_[:, 1] - pp_[:, 1]], 1)
        _share_within(f"K5 polish phases ({tag})", dp, torch.zeros_like(dp),
                      0.0, 0.01, 0.99)
        e5 = max(e5, float(dp.abs().max()))
    seed = _grid_phase_search(sr, si, f_d, x_range, piv, False,
                              polish_optimizer="fused", kernels=seeds_only)
    n_eval = POLISH_ITERS + 1  # the seed's evaluation and one per trial
    report["acme_polish"] = dict(
        err=e5,
        ms=_time_ms(lambda: acme_cuda.acme_polish(
            sr, si, f_d, piv, seed, x_range), 3),
        plain_ms=_time_ms(lambda: acme_cuda.acme_polish_plain(
            sr, si, f_d, piv, seed, x_range), 1, warmup=1),
        library_ms=None,
        # Rows read once; ~40 operations per point and evaluation (a sin, a
        # cos and a log counted as one each).
        bound=_bound(b * (8 * n_out + 4 + 16 + 12) + 4 * n_out,
                     n_eval * b * n_out * 40),
    )
    del sr, si, seed
    for name, r in report.items():
        lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.4f}"
        print(f"   {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
              f"{lib}, bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
    torch.cuda.empty_cache()

    # ---- 3b. the free-g instantiations: K2 at q_n = 2, SPD at F = 25 ----
    # The bench prior with every g freed to (0, 1) from 0.1: 25 free
    # parameters, Jacobian rows of t-degree (1, 2) (q_n = 2).
    _phase("3b free-g kernels: K2 at K=5, q_n=2, F=25; K3/K4/K6a/K6b at F=25")
    pk_g = prior_from_csv_text(_free_g_csv(bi.PK_CSV), "bench PK_CSV, g free")
    ps_g = hashable_pmap(pk_g.pmap)
    f_g = pk_g.n_free
    amp_slots_g, ls_plan_g = seed_plan(pk_g)
    g_plan = g_seed_plan(pk_g)
    xt_g = template_optimum(fids, pk_g, t_d, bi.MHZ)
    _, _, _, _, _, xt_gd, lower_g, upper_g, kind_g = grid_inputs_from_numpy(
        fids[:1], weight, freqs, t_np, xt_g, pk_g, dev)
    g_kw = dict(pmap_static=ps_g, mhz=bi.MHZ, amp_slots=amp_slots_g,
                ls_plan=ls_plan_g, g_scan=G_SCAN, g_plan=g_plan)
    u0_g = seed_grid(re, im, t_d, xt_gd, lower_g, upper_g, kind_g, **g_kw)
    x0_g, dxdu_g = internal_to_external_torch(u0_g, lower_g, upper_g, kind_g)
    grids_g = expand_params_batched(x0_g, ps_g).contiguous()
    dxdu_g = dxdu_g.contiguous()
    plan_g = normal_eq_plan(ps_g, f_g, bi.MHZ, True)
    if (f_g, plan_g.q_n, plan_g.n_peaks) != (25, 2, 5):
        raise AssertionError(f"free-g plan: F={f_g}, q_n={plan_g.q_n}")
    print(f"   free-g prior: F={f_g}, q_n={plan_g.q_n}; ptxas K2 (K=5, q_n=2): "
          f"{_ptxas_summary(log, 'lm_v9.cu', 'normal_eq_warp_kernelILi5ELi2E')}")
    cg_k, gg_k, hg_k = lm_cuda.eq6_normal_equations(grids_g, re, im, t_d,
                                                     dxdu_g, plan_g)
    cg_p, gg_p, hg_p = lm_cuda.eq6_normal_equations_plain(grids_g, re, im, t_d,
                                                          dxdu_g, plan_g)
    _sync()
    _assert_close("K2 q_n=2 cost", cg_k, cg_p, 1e-5, 0.0)
    h_atol, g_atol = _gram_atols(slab_to_bff(hg_p, f_g), cg_p, 1e-3)
    eg = max(_assert_close("K2 q_n=2 g", gg_k, gg_p, 1e-4, g_atol),
             _assert_close("K2 q_n=2 H", slab_to_bff(hg_k, f_g),
                           slab_to_bff(hg_p, f_g), 1e-4, h_atol))
    _row_blocks("K2 q_n=2", plan_g.active, slab_to_bff(hg_k, f_g),
                slab_to_bff(hg_p, f_g), h_atol, 1e-4)
    del h_atol, g_atol
    k2g_ops = n_in * (10 * kp_ + 6 + kp_ * (kp_ + 1) / 2 * (6 + 4 * (2 * 2 + 1))
                      + kp_ * (6 + 4 * (2 + 1)))
    free_g_report = {"eq6_normal_eq_v9 (q_n=2, F=25)": dict(
        err=eg,
        ms=_time_ms(lambda: lm_cuda.eq6_normal_equations(
            grids_g, re, im, t_d, dxdu_g, plan_g), 10),
        plain_ms=_time_ms(lambda: lm_cuda.eq6_normal_equations_plain(
            grids_g, re, im, t_d, dxdu_g, plan_g), 3),
        bound=_bound(b * 4 * (kp_ * 5 + 2 * n_in + f_g + 1 + f_g + f_g ** 2)
                     + 4 * n_in, b * k2g_ops))}
    hg_sp = hg_k.clone()
    hg_sp[0, planted] = -1.0
    hg_dense = slab_to_bff(hg_sp, f_g)
    outs_g = {
        "K3": (spd.spd_solve_damped(hg_sp, gg_k, lam),
               spd.spd_solve_damped_plain(hg_sp, gg_k, lam)),
        "K4": (spd.spd_inverse_diag(hg_sp, 1e-12),
               spd.spd_inverse_diag_plain(hg_sp, 1e-12)),
        "K6a": (spd.spd_solve_damped_dense(hg_dense, gg_k, lam),
                spd.spd_solve_damped_dense_plain(hg_dense, gg_k, lam)),
        "K6b": (spd.spd_inverse_diag_dense(hg_dense),
                spd.spd_inverse_diag_dense_plain(hg_dense)),
    }
    _sync()
    for name, (got, ref_) in outs_g.items():
        rows_nan = torch.isnan(got).all(1)
        if not torch.equal(rows_nan, bad) or torch.isnan(got[~bad]).any():
            raise AssertionError(f"{name} F=25: NaN rows are not the planted ones")
        if not _same_bits(got, ref_):
            raise AssertionError(f"{name} F=25: not bit for bit its plain version")
        print(f"   {name} at F=25: bit for bit its plain version, NaN rows at "
              f"the {int(bad.sum())} planted non-SPD voxels")
    hg_bff = slab_to_bff(hg_k, f_g)
    tri_g = f_g * (f_g + 1) // 2
    spd_flops_g = b * f_g ** 3 / 3.0
    for name, kern, plain_fn, nbytes, flops in (
            ("spd_solve_damped (F=25)",
             lambda: spd.spd_solve_damped(hg_k, gg_k, lam),
             lambda: spd.spd_solve_damped_plain(hg_k, gg_k, lam),
             b * 4 * (tri_g + 2 * f_g + 1), spd_flops_g + b * 2 * f_g ** 2),
            ("spd_inverse_diag (F=25)",
             lambda: spd.spd_inverse_diag(hg_k, 1e-12),
             lambda: spd.spd_inverse_diag_plain(hg_k, 1e-12),
             b * 4 * (tri_g + f_g), 2 * spd_flops_g),
            ("spd_solve_damped_dense (F=25)",
             lambda: spd.spd_solve_damped_dense(hg_bff, gg_k, lam),
             lambda: spd.spd_solve_damped_dense_plain(hg_bff, gg_k, lam),
             b * 4 * (tri_g + 2 * f_g + 1), spd_flops_g + b * 2 * f_g ** 2),
            ("spd_inverse_diag_dense (F=25)",
             lambda: spd.spd_inverse_diag_dense(hg_bff),
             lambda: spd.spd_inverse_diag_dense_plain(hg_bff),
             b * 4 * (tri_g + f_g), 2 * spd_flops_g)):
        free_g_report[name] = dict(err=0.0, ms=_time_ms(kern, 10),
                                   plain_ms=_time_ms(plain_fn, 3),
                                   bound=_bound(nbytes, flops))
    for name, r in free_g_report.items():
        print(f"   {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), "
              f"{r['ms'] / r['bound'][0]:.1f}x the bound")
    del outs_g, hg_sp, hg_dense, hg_bff, cg_p, gg_p, hg_p, cg_k, gg_k, hg_k
    del grids_g, dxdu_g, x0_g
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
    _check_path(K, counts, "grid_single_pivot")
    launches = dict(counts["launches"])
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
    x_range_t = f_d[-1] - f_d[0]

    def phi(a0, a1):
        return (torch.deg2rad(a0) + torch.deg2rad(a1)
                * ((f_d - pivot) / x_range_t)).reshape(n2, n1)[None]

    _rotated_close("slice spectra", sr, si, sr_p, si_p, phi(p0, p1) - phi(p0_p, p1_p))
    _assert_close("slice cost", cost, cost_p, 1e-4, 0.0)
    # The LM stops on float32-resolution criteria, so where the two paths'
    # K2 outputs differ in the last bits a few voxels stop at slightly
    # different points of a flat valley (equal cost).  The tolerances of
    # the CPU parity tests must hold for >= 99 % of voxels, and every voxel
    # within a tenth of its CRLB.
    _share_within("slice x_free", x_free, x_p, 2e-3, 2e-3, 0.99)
    _within_crlb("slice x_free", x_free, x_p, sds)
    _share_within("slice CRLB", sds, sds_p, 2e-2, 1e-4, 0.99)
    if not torch.equal(conv, conv_p):
        print(f"   note: converged flags differ on "
              f"{int((conv != conv_p).sum())} voxels")
    x9, cost9, sds9 = x_free, cost, sds  # the v9 grid, for 4d-4f
    del plain, sr_p, si_p, outs
    torch.cuda.empty_cache()

    # ---- 4b. per-voxel autophase (K1 + K5) ----
    _phase("4b per-voxel autophase: process_grid_planar_raw, autophase='all'")
    K.reset_counters()
    out = process_grid_planar_raw(*args, **fit_kw_all)
    _sync()
    counts = K.counters()
    print(f"   counters {counts}")
    _check_path(K, counts, "grid_per_voxel")
    launches["acme_polish"] = counts["launches"]["acme_polish"]
    sr, si, (p0s, p1s, pivs), x_all, _, conv_all, _ = out
    if sr.shape != (b, bi.ZERO_FILL) or p0s.shape != (b,) or pivs.shape != (b,):
        raise AssertionError("unexpected per-voxel output shapes")
    for name, val in (("spectra", sr), ("p0", p0s), ("p1", p1s)):
        if not torch.isfinite(val).all():
            raise AssertionError(f"non-finite per-voxel {name}")
    if not torch.isfinite(x_all).all() or float(conv_all.float().mean()) < 0.95:
        raise AssertionError("the per-voxel grid's fit failed")
    # (a) Same spectra: the plain polish on the kernel path's own spectra.
    same_spec = dataclasses.replace(K.PLAIN, spectrum=dft_cuda.spectrum)
    ref = spectral_pipeline_planar_raw(re, im, w_d, f_d, cfg_all,
                                       kernels=same_spec)
    (q0, q1, qpiv) = ref[2]
    if not torch.equal(qpiv, pivs):
        raise AssertionError("per-voxel pivots differ on the same spectra")
    dp = torch.stack([_wrapped(p0s - q0), p1s - q1], 1)
    _share_within("per-voxel phases vs the plain polish, same spectra", dp,
                  torch.zeros_like(dp), 0.0, 0.01, 0.99)
    del ref
    # (b) The plain path end to end (torch.fft spectra, plain polish).
    plain = spectral_pipeline_planar_raw(re, im, w_d, f_d, cfg_all,
                                         kernels=K.PLAIN)
    sr_p, si_p, (r0, r1, rpiv) = plain
    un_re, un_im = dft_cuda.spectrum(re, im, bi.ZERO_FILL, window=win)
    s_k = _acme_scores(acme_score_raw, _phased_real_planar, un_re, un_im, f_d,
                       p0s, p1s, pivs, x_range)
    s_p = _acme_scores(acme_score_raw, _phased_real_planar, un_re, un_im, f_d,
                       r0, r1, rpiv, x_range)
    _scores_both_ways("per-voxel ACME scores vs the plain path", s_k, s_p)
    share = float(((_wrapped(p0s - r0).abs() <= 0.01)
                   & ((p1s - r1).abs() <= 0.01)).double().mean())
    print(f"   per-voxel phases vs the plain path (torch.fft spectra): "
          f"{share:.5f} of voxels within 0.01 deg (reported; the flat ACME "
          f"valleys turn the spectra's last-bit differences into phase "
          f"differences at equal score)")

    def phi_v(a0, a1, pv):
        return (torch.deg2rad(a0)[:, None] + torch.deg2rad(a1)[:, None]
                * ((f_d[None, :] - pv[:, None]) / x_range_t))

    _rotated_close("per-voxel spectra", sr, si, sr_p, si_p,
                   phi_v(p0s, p1s, pivs) - phi_v(r0, r1, rpiv))
    del out, plain, sr_p, si_p, un_re, un_im, sr, si
    torch.cuda.empty_cache()

    # ---- 4c. fit_amares on the labeled bench grid (K2 + K3 + K6b) ----
    _phase("4c fit_amares on the bench grid as an (x, y, z, time) array")
    da = XmrArray(fids.reshape(bi.GRID + (bi.N_TIME,)),
                  dims=("x", "y", "z", "time"),
                  coords={"time": Coord("time", t_np.astype(np.float64))},
                  attrs={"MHz": bi.MHZ})
    K.reset_counters()
    t0 = time.perf_counter()
    ds = fit_amares(da, pk)
    _sync()
    fit_s = time.perf_counter() - t0
    counts = K.counters()
    print(f"   fit_amares in {fit_s:.3f} s; counters {counts}")
    _check_path(K, counts, "fit_amares")
    launches["spd_inverse_diag_dense"] = counts["launches"]["spd_inverse_diag_dense"]
    amp = ds["amplitude"].values
    if amp.shape != bi.GRID + (pk.n_peaks,) or ds["raw_data"].dims != da.dims:
        raise AssertionError("unexpected fit_amares dataset layout")
    conv_share = float(ds["fit_converged"].values.mean())
    amp_pcr = amp.reshape(b, -1)[:, 0]
    pcr_err = float(np.median(np.abs(amp_pcr - bi.pcr_amplitudes())
                              / bi.pcr_amplitudes()))
    print(f"   converged share {conv_share:.4f} (limit >= 0.95); PCr median "
          f"rel err {pcr_err:.5f} (limit <= 0.05)")
    if conv_share < 0.95 or not pcr_err <= 0.05:
        raise AssertionError("fit_amares quality check failed")
    ds_p = fit_amares(da, pk, kernels=K.PLAIN)
    # Per family (amplitude, shift, linewidth, phase): (B, n_peaks) maps of
    # both paths and the Jacobian CRLB of each parameter at the kernel
    # path's solution (the reference's crlb_batched on the same data).
    fams = ("amplitude", "chem_shift", "linewidth", "phase")
    got = np.stack([ds[n].values.reshape(b, -1) for n in fams])
    ref = np.stack([ds_p[n].values.reshape(b, -1) for n in fams])
    x_k = np.zeros((b, n_free), np.float32)
    slots = np.asarray(pk.pmap.idx).reshape(-1, 5)[:, :4].T  # (4, n_peaks)
    for c in range(4):
        for k in range(pk.n_peaks):
            j, s = 5 * k + c, slots[c, k]
            if s >= 0 and pk.pmap.scale[j] == 1.0:
                x_k[:, s] = got[c, :, k] - pk.pmap.offset[j]
    sds_k, _ = crlb_batched_planar(re, im, t_d, torch.as_tensor(x_k, device=dev),
                                   ps, bi.MHZ)
    sds_k = sds_k.cpu().numpy()
    sd = np.where(slots[:, None, :] >= 0, sds_k[:, np.maximum(slots, 0)]
                  .transpose(1, 0, 2), 0.0)
    # The LM's float32 stopping rules and the refinement pass's keep-the-
    # lower-cost choice between float32-equal costs move a few voxels
    # along flat valleys: every parameter within a tenth of its CRLB, and
    # amplitudes, shifts and linewidths to the CPU tests' 2e-3 for >= 99 %
    # of voxels; the phases' share at 2e-3 degrees is reported.
    _within_crlb("fit_amares parameters", torch.as_tensor(got),
                 torch.as_tensor(ref), torch.as_tensor(sd))
    for c, n in enumerate(fams):
        ok = (np.abs(got[c] - ref[c]) <= 2e-3 + 2e-3 * np.abs(ref[c])).all(1)
        print(f"   fit_amares {n}: {ok.mean():.5f} of voxels within rtol 2e-3 "
              f"/ atol 2e-3" + (" (limit >= 0.99)" if n != "phase" else
                                " (reported)"))
        if n != "phase" and ok.mean() < 0.99:
            raise AssertionError(f"fit_amares {n}: too few voxels within 2e-3")
    _share_within("fit_amares CRLB %", torch.as_tensor(ds["crlb"].values).reshape(b, -1),
                  torch.as_tensor(ds_p["crlb"].values).reshape(b, -1), 2e-2, 1e-4,
                  0.99)
    del ds_p, got, ref
    torch.cuda.empty_cache()

    # ---- 4d-4k. the grid at every other kernel_version ----
    # 10 (K8), 3 (K7), 5 (K12), 8 (K9), 6 (K11), 7 (K10), 2 (K13), 1 (K14).
    # Each against the v9 grid of phase 4 on the same inputs, by the share of
    # voxels within the reference's own tolerances between these versions:
    # test_lm_pallas_v10.py:99-111 for 10 (x rtol/atol 1e-4, cost rtol
    # 1e-5), test_lm_pallas.py:1363 for the others (x rtol/atol 0.02), CRLB
    # rtol 1e-3 (10) and 0.05 (the others); and every voxel within 0.1 CRLB.
    tols = {v: (0.02, 1e-4, 0.05) for v in (3, 5, 8, 6, 7, 2, 1)}
    tols[10] = (1e-4, 1e-5, 1e-3)
    for tag, v in (("4d", 10), ("4e", 3), ("4f", 5), ("4g", 8), ("4h", 6),
                   ("4i", 7), ("4j", 2), ("4k", 1)):
        _phase(f"{tag} process_grid_planar_raw, kernel_version={v}")
        K.reset_counters()
        out = process_grid_planar_raw(*args, **fit_kw, kernel_version=v)
        _sync()
        counts = K.counters()
        print(f"   counters {counts}")
        path = f"grid_single_pivot_v{v}"
        _check_path(K, counts, path)
        for name in K.PATHS[path]:  # the new kernels' counts, first path
            if not launches[name]:
                launches[name] = counts["launches"][name]
        x_v, cost_v, conv_v, sds_v = out[3:]
        for name, val in (("x_free", x_v), ("cost", cost_v)):
            if not torch.isfinite(val).all():
                raise AssertionError(f"v{v}: non-finite {name}")
        conv_share = float(conv_v.float().mean())
        pcr_err = float(((x_v[:, slot].double() - truth).abs() / truth).median())
        print(f"   converged share {conv_share:.4f} (limit >= 0.95); PCr median "
              f"rel err {pcr_err:.5f} (limit <= 0.05)")
        if conv_share < 0.95 or not pcr_err <= 0.05:
            raise AssertionError(f"v{v} grid: fit quality check failed")
        bits = float(((x_v == x9).all(1) & (cost_v == cost9)).double().mean())
        print(f"   v{v} vs v9: {bits:.5f} of voxels bit identical (x, cost)")
        x_tol, c_tol, s_tol = tols[v]
        _share_within(f"v{v} x_free vs v9", x_v, x9, x_tol, x_tol, 0.99)
        _share_within(f"v{v} cost vs v9", cost_v[:, None], cost9[:, None],
                      c_tol, 0.0, 0.99)
        _share_within(f"v{v} CRLB vs v9", sds_v, sds9, s_tol, 1e-4, 0.99)
        _within_crlb(f"v{v} x_free vs v9", x_v, x9, sds9)
        del out, x_v, cost_v, conv_v, sds_v
        torch.cuda.empty_cache()

    # ---- 4l. fit_amares(kernel_version=10) (K8 + K6b) ----
    _phase("4l fit_amares(kernel_version=10) on the bench grid")
    K.reset_counters()
    ds10 = fit_amares(da, pk, kernel_version=10)
    _sync()
    counts = K.counters()
    print(f"   counters {counts}")
    _check_path(K, counts, "fit_amares_v10")
    amp10 = ds10["amplitude"].values.reshape(b, -1)
    conv_share = float(ds10["fit_converged"].values.mean())
    pcr_err = float(np.median(np.abs(amp10[:, 0] - bi.pcr_amplitudes())
                              / bi.pcr_amplitudes()))
    print(f"   converged share {conv_share:.4f} (limit >= 0.95); PCr median "
          f"rel err {pcr_err:.5f} (limit <= 0.05)")
    if conv_share < 0.95 or not pcr_err <= 0.05:
        raise AssertionError("fit_amares v10 quality check failed")
    got = np.stack([ds10[n].values.reshape(b, -1) for n in fams])
    ref = np.stack([ds[n].values.reshape(b, -1) for n in fams])
    bits = float((got == ref).all(axis=(0, 2)).mean())
    print(f"   v10 vs v9 maps: {bits:.5f} of voxels bit identical")
    _within_crlb("fit_amares v10 parameters", torch.as_tensor(got),
                 torch.as_tensor(ref), torch.as_tensor(sd))
    for c, n in enumerate(fams):
        ok = (np.abs(got[c] - ref[c]) <= 1e-4 + 1e-4 * np.abs(ref[c])).all(1)
        print(f"   fit_amares v10 {n}: {ok.mean():.5f} of voxels within rtol "
              f"1e-4 / atol 1e-4 of v9" + (" (limit >= 0.99)" if n != "phase"
                                           else " (reported)"))
        if n != "phase" and ok.mean() < 0.99:
            raise AssertionError(f"fit_amares v10 {n}: too few voxels within 1e-4")
    _share_within("fit_amares v10 CRLB %",
                  torch.as_tensor(ds10["crlb"].values).reshape(b, -1),
                  torch.as_tensor(ds["crlb"].values).reshape(b, -1), 2e-2, 1e-4,
                  0.99)
    del ds10, got, ref
    torch.cuda.empty_cache()

    # ---- 4m. fit_amares(kernel_version=8) (K9 + K6a + K6b) ----
    # Another evaluation kernel than v9's: held like the v8 grid (every
    # parameter within 0.1 CRLB of 4c's maps, amplitudes, shifts and
    # linewidths within 0.02 for >= 99 % of voxels, CRLB % within 0.05).
    _phase("4m fit_amares(kernel_version=8) on the bench grid")
    K.reset_counters()
    ds8 = fit_amares(da, pk, kernel_version=8)
    _sync()
    counts = K.counters()
    print(f"   counters {counts}")
    _check_path(K, counts, "fit_amares_v8")
    amp8 = ds8["amplitude"].values.reshape(b, -1)
    conv_share = float(ds8["fit_converged"].values.mean())
    pcr_err = float(np.median(np.abs(amp8[:, 0] - bi.pcr_amplitudes())
                              / bi.pcr_amplitudes()))
    print(f"   converged share {conv_share:.4f} (limit >= 0.95); PCr median "
          f"rel err {pcr_err:.5f} (limit <= 0.05)")
    if conv_share < 0.95 or not pcr_err <= 0.05:
        raise AssertionError("fit_amares v8 quality check failed")
    got = np.stack([ds8[n].values.reshape(b, -1) for n in fams])
    ref = np.stack([ds[n].values.reshape(b, -1) for n in fams])
    _within_crlb("fit_amares v8 parameters", torch.as_tensor(got),
                 torch.as_tensor(ref), torch.as_tensor(sd))
    for c, n in enumerate(fams):
        ok = (np.abs(got[c] - ref[c]) <= 0.02 + 0.02 * np.abs(ref[c])).all(1)
        print(f"   fit_amares v8 {n}: {ok.mean():.5f} of voxels within rtol "
              f"0.02 / atol 0.02 of v9" + (" (limit >= 0.99)" if n != "phase"
                                           else " (reported)"))
        if n != "phase" and ok.mean() < 0.99:
            raise AssertionError(f"fit_amares v8 {n}: too few voxels within 0.02")
    _share_within("fit_amares v8 CRLB %",
                  torch.as_tensor(ds8["crlb"].values).reshape(b, -1),
                  torch.as_tensor(ds["crlb"].values).reshape(b, -1), 0.05, 1e-4,
                  0.99)
    del ds8, got, ref
    torch.cuda.empty_cache()

    # ---- 4n. the accept gate in the LM (K2 with cost_prev) ----
    # The gate changes what K2 computes, not what the loop consumes: the
    # gated fit of the bench seeds equals the ungated one bit for bit, and
    # kernel_version=10 with the gate runs the v9 loop (K2 + K3), not K8.
    _phase("4n lm_fit_batched_pallas(gate_rejects=True) on the bench seeds")
    lm_args = (re, im, t_d, u0, lower, upper, kind, ps, bi.MHZ)
    lm_kw = dict(max_iter=24, require_uniform_t=True)
    open_fit = lm_fit_batched_pallas(*lm_args, **lm_kw)
    for v in (9, 10):
        K.reset_counters()
        gated = lm_fit_batched_pallas(*lm_args, **lm_kw, kernel_version=v,
                                      gate_rejects=True)
        _sync()
        counts = K.counters()["launches"]
        if counts["lm_loop_v10"] or not counts["eq6_normal_eq_v9"]:
            raise AssertionError(f"gated v{v}: K2 did not run the loop")
        if not all(torch.equal(x, y) for x, y in
                   zip(gated[:3], open_fit[:3])):
            raise AssertionError(f"gated v{v} fit differs from the open fit")
        print(f"   gate_rejects, kernel_version={v}: {counts['eq6_normal_eq_v9']} "
              f"K2 launches, K8 none; x, cost and n_iter bit for bit the "
              f"ungated v9 fit")
    del open_fit, gated

    # ---- 4o. the free-g grid at full width (K2 q_n=2 + K3 + K4, VARPRO) ----
    _phase("4o seeded_fit_grid_raw, the bench prior with g free (F=25), "
           "g scan, v9 slab")
    g_fit = dict(g_kw, max_iter=24, plateau_streak=3, uniform_t_ok=True)
    g_args = (re, im, t_d, xt_gd, lower_g, upper_g, kind_g)
    K.reset_counters()
    xg, cg, convg, sdsg = seeded_fit_grid_raw(*g_args, **g_fit)
    _sync()
    counts = K.counters()
    print(f"   counters {counts}")
    _check_path(K, counts, "seeded_fit")
    free_g_launches = {"grid": dict(counts["launches"])}
    conv_g = float(convg.float().mean())
    pcr_g = float(((xg[:, int(pk_g.pmap.idx[0])].double() - truth).abs()
                   / truth).median())
    g_slots = [s_ for s_, _, _, _ in g_plan]
    print(f"   converged share {conv_g:.4f} (limit >= 0.95); PCr median rel "
          f"err {pcr_g:.5f} (limit <= 0.05); g median {float(xg[:, g_slots].median()):.4f}")
    if not (torch.isfinite(xg).all() and torch.isfinite(cg).all()):
        raise AssertionError("free-g grid: non-finite x or cost")
    if conv_g < 0.95 or not pcr_g <= 0.05:
        raise AssertionError("free-g grid: fit quality check failed")
    xg_p, cg_p, _, sdsg_p = seeded_fit_grid_raw(*g_args, **g_fit,
                                                kernels=K.PLAIN)
    _sync()
    cost_g = _cost_not_worse("free-g grid cost vs plain", cg, cg_p, 0.995)
    # Control: the plain path on data one float32 ulp up (every real
    # sample), which shows how far two roundings of the same unfinished
    # descents drift apart.
    re_u = torch.nextafter(re, torch.full_like(re, float("inf")))
    cg_u = seeded_fit_grid_raw(re_u, *g_args[1:], **g_fit, kernels=K.PLAIN)[1]
    ctl_g = _cost_not_worse("control: plain path on data one ulp up vs plain",
                            cg_u, cg_p, None)
    del re_u, cg_u
    share_x = _share_within("free-g grid x_free vs plain (reported)", xg, xg_p,
                            2e-3, 2e-3, 0.0)
    _within_crlb("free-g grid x_free vs plain (reported)", xg, xg_p, sdsg,
                 limit=None)
    del xg_p, cg_p, sdsg_p
    # In turns with the fixed-g grid fit of the same voxels; the g-scan
    # seeding, and the LM with the override against it switched off, apart.
    u0_gt = seed_grid(re, im, t_d, xt_gd, lower_g, upper_g, kind_g, **g_kw)
    lm_g = dict(kernels=K.DISPATCH, max_iter=24, lam0=1e-3, ftol=1e-10,
                kernel_version=9, return_hessian="slab", uniform_t_ok=True,
                plateau_streak=3, spd_pallas=True)
    fit_only = {k: v for k, v in fit_kw.items() if k != "cfg"}
    g_turns = {k: [] for k in ("free-g grid", "fixed-g grid", "g-scan seeding",
                               "free-g LM, override on", "free-g LM, override off")}
    g_fns = {
        "free-g grid": lambda: seeded_fit_grid_raw(*g_args, **g_fit),
        "fixed-g grid": lambda: seeded_fit_grid_raw(
            re, im, t_d, xt_d, lower, upper, kind, **fit_only),
        "g-scan seeding": lambda: seed_grid(
            re, im, t_d, xt_gd, lower_g, upper_g, kind_g, **g_kw),
        "free-g LM, override on": lambda: _lm_fit_batched_pallas_impl(
            re, im, t_d, u0_gt, lower_g, upper_g, kind_g, ps_g, bi.MHZ,
            varpro=True, **lm_g),
        "free-g LM, override off": lambda: _lm_fit_batched_pallas_impl(
            re, im, t_d, u0_gt, lower_g, upper_g, kind_g, ps_g, bi.MHZ,
            varpro=False, **lm_g),
    }
    for rnd in range(5):
        for name in (list(g_fns) if rnd % 2 == 0 else list(g_fns)[::-1]):
            _sync()
            t0 = time.perf_counter()
            g_fns[name]()
            _sync()
            g_turns[name].append(1e3 * (time.perf_counter() - t0))
    g_ms = {k: float(np.median(v)) for k, v in g_turns.items()}
    for name, xs in g_turns.items():
        print(f"   in turns, {name}: median {g_ms[name]:.3f} ms "
              f"({', '.join(f'{x:.1f}' for x in xs)})")
    K.reset_counters()
    done_g = {}
    for on in (True, False):
        res_on = _lm_fit_batched_pallas_impl(
            re, im, t_d, u0_gt, lower_g, upper_g, kind_g, ps_g, bi.MHZ,
            varpro=on, **lm_g)[0]
        done_g["on" if on else "off"] = float(res_on.done.float().mean())
        print(f"   free-g LM, override {'on' if on else 'off'}: accepted steps "
              f"median {float(res_on.n_iter.float().median()):.1f}, done "
              f"{float(res_on.done.float().mean()):.4f}, cost sum "
              f"{float(res_on.cost.double().sum()):.6e}")
    print(f"   K2 / K3 launches for both LMs: "
          f"{K.counters()['launches']['eq6_normal_eq_v9']} / "
          f"{K.counters()['launches']['spd_solve_damped']}")
    del u0_gt, res_on
    # The same grid fit on a Voigt phantom (every peak at g = 0.5), where
    # g can be identified and descents finish before max_iter.
    fids_v = bi.make_inputs(bi.GRID, g=0.5)[0]
    xt_gv = template_optimum(fids_v, pk_g, t_d, bi.MHZ)
    re_v, im_v, *_, xt_gvd, _, _, _ = grid_inputs_from_numpy(
        fids_v, weight, freqs, t_np, xt_gv, pk_g, dev)
    v_args = (re_v, im_v, t_d, xt_gvd, lower_g, upper_g, kind_g)
    xv, cv, convv, _ = seeded_fit_grid_raw(*v_args, **g_fit)
    u0_v = seed_grid(*v_args, **g_kw)
    res_v = _lm_fit_batched_pallas_impl(
        re_v, im_v, t_d, u0_v, lower_g, upper_g, kind_g, ps_g, bi.MHZ,
        varpro=True, **lm_g)[0]
    voigt_ms = []
    for _ in range(3):
        _sync()
        t0 = time.perf_counter()
        seeded_fit_grid_raw(*v_args, **g_fit)
        _sync()
        voigt_ms.append(1e3 * (time.perf_counter() - t0))
    voigt = {"ms": float(np.median(voigt_ms)),
             "converged": float(convv.float().mean()),
             "done": float(res_v.done.float().mean()),
             "n_iter_median": float(res_v.n_iter.float().median()),
             "g_median": float(xv[:, g_slots].median()),
             "pcr_err": float(((xv[:, int(pk_g.pmap.idx[0])].double() - truth)
                               .abs() / truth).median())}
    print(f"   Voigt phantom (g = 0.5): free-g grid median {voigt['ms']:.3f} ms "
          f"({', '.join(f'{x:.1f}' for x in voigt_ms)}); converged "
          f"{voigt['converged']:.4f}, LM done {voigt['done']:.4f}, accepted "
          f"steps median {voigt['n_iter_median']:.1f}, g median "
          f"{voigt['g_median']:.4f}, PCr median rel err {voigt['pcr_err']:.5f}")
    if not (torch.isfinite(xv).all() and torch.isfinite(cv).all()):
        raise AssertionError("free-g grid on the Voigt phantom: non-finite x "
                             "or cost")
    del fids_v, re_v, im_v, v_args, xv, cv, convv, u0_v, res_v
    torch.cuda.empty_cache()

    # ---- 4p. fit_amares on the same array with the free-g prior ----
    _phase("4p fit_amares, the bench prior with g free (g_scan='auto')")
    K.reset_counters()
    t0 = time.perf_counter()
    ds_g = fit_amares(da, pk_g)
    _sync()
    fit_g_s = time.perf_counter() - t0
    counts = K.counters()
    print(f"   fit_amares in {fit_g_s:.3f} s; counters {counts}")
    _check_path(K, counts, "fit_amares")
    free_g_launches["fit_amares"] = dict(counts["launches"])
    amp_g = ds_g["amplitude"].values.reshape(b, -1)
    conv_fg = float(ds_g["fit_converged"].values.mean())
    pcr_fg = float(np.median(np.abs(amp_g[:, 0] - bi.pcr_amplitudes())
                             / bi.pcr_amplitudes()))
    print(f"   converged share {conv_fg:.4f} (limit >= 0.95); PCr median rel "
          f"err {pcr_fg:.5f} (limit <= 0.05)")
    if conv_fg < 0.95 or not pcr_fg <= 0.05:
        raise AssertionError("free-g fit_amares quality check failed")
    staged = stage_device_fids(da)
    ds_s = fit_amares(da, pk_g, device_fids=staged)
    _sync()
    if not all(np.array_equal(ds_s[n].values, ds_g[n].values)
               for n in ds_g.data_vars):
        raise AssertionError("fit_amares with staged planes differs")
    print("   staged planes (pinned, side stream, event): the same dataset, "
          "bit for bit")
    del ds_s, staged
    ds_gp = fit_amares(da, pk_g, kernels=K.PLAIN)
    t_ax = ds_g["residuals"].dims.index("time")

    def res_cost(d):
        return np.sum(np.abs(d["residuals"].values) ** 2, axis=t_ax).reshape(-1)

    cost_fg = _cost_not_worse("fit_amares residual cost vs plain",
                              res_cost(ds_g), res_cost(ds_gp), 0.995)
    fids_u = (np.nextafter(fids.real, np.float32(np.inf))
              + 1j * fids.imag).astype(np.complex64)
    da_u = XmrArray(fids_u.reshape(bi.GRID + (bi.N_TIME,)), dims=da.dims,
                    coords=da.coords, attrs=da.attrs)
    ctl_fg = _cost_not_worse(
        "control: plain fit_amares on data one ulp up vs plain",
        res_cost(fit_amares(da_u, pk_g, kernels=K.PLAIN)), res_cost(ds_gp),
        None)
    del fids_u, da_u
    fams_g = [np.stack([d[n].values.reshape(b, -1) for n in fams])
              for d in (ds_g, ds_gp)]
    ok = np.all(np.abs(fams_g[0] - fams_g[1])
                <= 2e-3 + 2e-3 * np.abs(fams_g[1]), axis=(0, 2))
    share_fg = float(ok.mean())
    print(f"   fit_amares maps vs the plain KernelSet: {share_fg:.5f} of voxels "
          f"within rtol/atol 2e-3 (reported)")
    del ds_gp, fams_g
    os.environ["XMT_FIT_STAGE_TIMERS"] = "1"
    fit_g_times = []
    for _ in range(3):
        _sync()
        t0 = time.perf_counter()
        fit_amares(da, pk_g)
        _sync()
        fit_g_times.append(time.perf_counter() - t0)
    del os.environ["XMT_FIT_STAGE_TIMERS"]
    fit_g_med = float(np.median(fit_g_times))
    print(f"   fit_amares (free g) times s: {[round(x, 3) for x in fit_g_times]}; "
          f"median {fit_g_med:.3f} s = {b / fit_g_med:.1f} voxels/s")
    del ds_g
    torch.cuda.empty_cache()

    # ---- 4q. process_grid_planar_raw at PipelineConfig defaults (DE) ----
    _phase("4q process_grid_planar_raw at PipelineConfig(zero_fill_to=2048) "
           "defaults: DE on the pivot row")
    cfg_de = PipelineConfig(zero_fill_to=bi.ZERO_FILL)
    if cfg_de.ap_optimizer != "de" or cfg_de.autophase != "single":
        raise AssertionError("PipelineConfig defaults moved")
    de_kw = dict(fit_kw, cfg=cfg_de)
    K.reset_counters()
    out = process_grid_planar_raw(*args, **de_kw)
    _sync()
    counts = K.counters()
    print(f"   counters {counts}")
    _check_path(K, counts, "grid_single_pivot")
    _, _, (p0d, p1d, pivd), xd, _, convd, _ = out
    if float(pivd) != float(pivot):
        raise AssertionError("the DE grid chose another pivot")
    if not torch.isfinite(xd).all() or float(convd.float().mean()) < 0.95:
        raise AssertionError("the DE grid's fit failed")
    un_re, un_im, mv, mi = dft_cuda.spectrum(re, im, bi.ZERO_FILL, window=win,
                                             with_maxmag=True)
    v_piv = int(torch.argmax(mv))
    row = (un_re[v_piv:v_piv + 1].double(), un_im[v_piv:v_piv + 1].double())

    def row_score(a0, a1):
        return float(acme_score_raw(_phased_real_planar(
            *row, f_d.double(), a0.double().reshape(1), a1.double().reshape(1),
            pivot.double(), x_range))[0])

    s_de, s_grid = row_score(p0d, p1d), row_score(p0, p1)
    print(f"   DE (p0, p1) = ({float(p0d):.4f}, {float(p1d):.4f}), ACME "
          f"{s_de:.6e}; grid search ({float(p0):.4f}, {float(p1):.4f}), ACME "
          f"{s_grid:.6e}; DE/grid {s_de / s_grid:.6f}")
    if not s_de <= s_grid * 1.02:
        raise AssertionError("DE pivot phase scores above x1.02 the grid's")
    de_turns = {"DE pivot grid": [], "grid-search pivot grid": []}
    for rnd in range(5):
        order = list(de_turns) if rnd % 2 == 0 else list(de_turns)[::-1]
        for name in order:
            kw = de_kw if name == "DE pivot grid" else fit_kw
            _sync()
            t0 = time.perf_counter()
            process_grid_planar_raw(*args, **kw)
            _sync()
            de_turns[name].append(1e3 * (time.perf_counter() - t0))
    de_ms = {k: float(np.median(v)) for k, v in de_turns.items()}
    for name, xs in de_turns.items():
        print(f"   in turns, {name}: median {de_ms[name]:.3f} ms "
              f"({', '.join(f'{x:.1f}' for x in xs)})")
    del out
    torch.cuda.empty_cache()

    # ---- 4r. per-voxel DE on the full bench grid ----
    _phase("4r per-voxel DE: process_grid_planar_raw, autophase='all', "
           "ap_optimizer='de'")
    cfg_all_de = PipelineConfig(zero_fill_to=bi.ZERO_FILL, autophase="all",
                                spec_layout="flat", ap_optimizer="de")
    n_pop = 15 * 2
    chunk = de_chunk_rows(b, n_pop, bi.ZERO_FILL)
    K.reset_counters()
    _sync()
    t0 = time.perf_counter()
    out = process_grid_planar_raw(*args, **dict(fit_kw, cfg=cfg_all_de))
    _sync()
    pv_de_s = time.perf_counter() - t0
    counts = K.counters()
    print(f"   one grid in {pv_de_s:.3f} s (DE chunk {chunk} voxels); counters "
          f"{counts}")
    _check_path(K, counts, "grid_per_voxel_de")
    _, _, (q0, q1, qpiv), _, _, _, _ = out
    if not (torch.isfinite(q0).all() and torch.isfinite(q1).all()):
        raise AssertionError("per-voxel DE: non-finite phases")
    if not torch.equal(qpiv, f_d[mi.long()]):
        raise AssertionError("per-voxel DE: pivots are not the peaks")
    s_vde = _acme_scores(acme_score_raw, _phased_real_planar, un_re, un_im, f_d,
                         q0, q1, qpiv, x_range)
    s_vgr = _acme_scores(acme_score_raw, _phased_real_planar, un_re, un_im, f_d,
                         p0s, p1s, pivs, x_range)
    ratio = (s_vde.double() / s_vgr.double())
    fin = torch.isfinite(ratio)
    print(f"   per-voxel ACME, DE / grid search: median "
          f"{float(ratio[fin].median()):.6f}, share <= x1.001 "
          f"{float((ratio[fin] <= 1.001).double().mean()):.5f}, share > x1.02 "
          f"{float((ratio[fin] > 1.02).double().mean()):.5f}")
    if float(ratio[fin].median()) > 1.02:
        raise AssertionError("per-voxel DE scores above the grid search's")
    del out
    torch.cuda.empty_cache()
    chunk_s = {}
    for c in (2048, 4096, 8192, 16384):
        try:
            _sync()
            t0 = time.perf_counter()
            _de_phase_search(un_re, un_im, f_d, x_range, qpiv, False,
                             maxiter=200, chunk=c)
            _sync()
            chunk_s[c] = time.perf_counter() - t0
        except torch.cuda.OutOfMemoryError:
            chunk_s[c] = None
        torch.cuda.empty_cache()
        print(f"   per-voxel DE search alone, chunk {c}: "
              + ("out of memory" if chunk_s[c] is None
                 else f"{chunk_s[c]:.3f} s"), flush=True)
    del un_re, un_im, mv, mi, s_vde, s_vgr
    torch.cuda.empty_cache()

    # ---- 4s. mrsi_pipeline, the labeled front-end (K1) ----
    _phase("4s mrsi_pipeline on the bench grid as an (x, y, z, time) array")
    cfg_m = PipelineConfig(zero_fill_to=bi.ZERO_FILL)
    if (cfg_m.lb, cfg_m.gb, cfg_m.ap_optimizer) != (5.0, 0.0, "de"):
        raise AssertionError("PipelineConfig defaults moved")
    n_out, w_m, f_m64 = spectral_constants(da.coords["time"].values, cfg_m)
    w_m = torch.as_tensor(w_m, dtype=torch.float32, device=dev)
    f_m = torch.as_tensor(f_m64, dtype=torch.float32, device=dev)
    mrsi_cfgs = {
        "DE default": cfg_m,
        "grid search": dataclasses.replace(cfg_m, ap_optimizer="grid"),
    }
    mrsi_out = {}
    for name, c in mrsi_cfgs.items():
        out_m = _mrsi_run(K, mrsi_pipeline, da, c, "mrsi_pipeline", 1)
        raw = spectral_pipeline_planar_raw(re, im, w_m, f_m, c)
        _sync()
        _same_as_raw(f"mrsi_pipeline ({name})", out_m, raw, b, n_out)
        mrsi_out[name] = out_m
        print(f"   {name}: (p0, p1) = ({out_m.attrs['phase_p0']:.4f}, "
              f"{out_m.attrs['phase_p1']:.4f}), pivot "
              f"{out_m.attrs['phase_pivot']:.4f} Hz; lineage "
              f"{sorted(k for k in out_m.attrs if k != 'MHz')}")
    cfg_lg = dataclasses.replace(cfg_m, gb=8.0, autophase="none")
    out_lg = _mrsi_run(K, mrsi_pipeline, da, cfg_lg, "mrsi_pipeline", 1)
    chain = to_spectrum(apodize_lg(zero_fill(da.to(dev), target_points=n_out),
                                   lb=cfg_lg.lb, gb=cfg_lg.gb))
    _sync()
    want = chain.data.reshape(b, n_out)
    got = torch.as_tensor(out_lg.values.reshape(b, n_out), device=dev)
    sc = float(torch.maximum(want.real.abs().max(), want.imag.abs().max()))
    _assert_close("mrsi_pipeline gb=8 vs zero_fill/apodize_lg/to_spectrum re",
                  got.real, want.real, 0.0, 1e-6 * sc)
    _assert_close("mrsi_pipeline gb=8 vs zero_fill/apodize_lg/to_spectrum im",
                  got.imag, want.imag, 0.0, 1e-6 * sc)
    if out_lg.attrs.get("apodization_gb") != 8.0 or "phase_p0" in out_lg.attrs:
        raise AssertionError("mrsi_pipeline gb=8: wrong lineage")
    del chain, want, got, out_lg, raw
    torch.cuda.empty_cache()

    # ---- 4t. per-voxel mrsi_pipeline (K1 + K5) ----
    _phase("4t mrsi_pipeline, autophase='all' with the grid search")
    cfg_mv = dataclasses.replace(cfg_m, autophase="all", ap_optimizer="grid")
    out_mv = _mrsi_run(K, mrsi_pipeline, da, cfg_mv, "mrsi_pipeline_per_voxel",
                       1)
    out_mp = mrsi_pipeline(da, cfg=cfg_mv, kernels=K.PLAIN)
    _sync()
    un_re, un_im, mv_m, _ = dft_cuda.spectrum(
        re, im, bi.ZERO_FILL, window=w_m[:bi.N_TIME].contiguous(),
        with_maxmag=True)

    def attrs_t(o):
        return tuple(torch.as_tensor(np.ravel(o.attrs[f"phase_{k}"]),
                                     device=dev, dtype=torch.float32)
                     for k in ("p0", "p1", "pivot"))

    s_k = _acme_scores(acme_score_raw, _phased_real_planar, un_re, un_im, f_m,
                       *attrs_t(out_mv), x_range)
    s_p = _acme_scores(acme_score_raw, _phased_real_planar, un_re, un_im, f_m,
                       *attrs_t(out_mp), x_range)
    _scores_both_ways("per-voxel mrsi_pipeline ACME vs the plain KernelSet",
                      s_k, s_p)
    if np.shape(out_mv.attrs["phase_p0"]) != bi.GRID:
        raise AssertionError("per-voxel mrsi_pipeline: phases not voxel-shaped")
    del out_mv, out_mp, s_k, s_p
    torch.cuda.empty_cache()

    # ---- 4u. the Newton and BFGS polishes, per voxel ----
    _phase("4u per-voxel grid search with ap_polish newton / bfgs vs gd")
    polish_scores, polish_p = {}, {}
    for pol in ("gd", "newton", "bfgs"):
        c = dataclasses.replace(cfg_all, ap_polish=pol)
        K.reset_counters()
        _, _, (q0, q1, qpiv) = spectral_pipeline_planar_raw(re, im, w_d, f_d, c)
        _sync()
        counts = K.counters()
        if (counts["launches"]["acme_polish"] != 0
                or counts["launches"]["spectrum"] != 1
                or any(counts["plain_calls"].values())):
            raise AssertionError(f"ap_polish={pol}: unexpected launches "
                                 f"{counts}")
        if not (torch.isfinite(q0).all() and torch.isfinite(q1).all()
                and float(q0.abs().max()) <= 180.0
                and float(q1.abs().max()) <= 4000.0):
            raise AssertionError(f"ap_polish={pol}: phases out of the box")
        u_re, u_im = dft_cuda.spectrum(re, im, bi.ZERO_FILL, window=win)
        polish_scores[pol] = _acme_scores(acme_score_raw, _phased_real_planar,
                                          u_re, u_im, f_d, q0, q1, qpiv,
                                          x_range).double()
        polish_p[pol] = (float(q0.abs().max()), float(q1.abs().max()))
    # Held to what the reference's own polishes do on this grid (its
    # newton-18 / bfgs-28 against its gd-40, the whole bench grid on the
    # CPU: median x1.00050 / x1.00037, 70.1 % / 74.6 % of voxels within
    # x1.001, 0 / 2 voxels above x1.02 (max 1.0088 / 1.0542)): the median
    # within x1.001 and at most 0.1 % of voxels above x1.02 + 1e-9 (the
    # reference's bar for a polish variant, tests/test_acme_pallas.py:163).
    for pol in ("newton", "bfgs"):
        r = polish_scores[pol] / polish_scores["gd"]
        fin = torch.isfinite(r)
        med = float(r[fin].median())
        above = int((polish_scores[pol][fin]
                     > polish_scores["gd"][fin] * 1.02 + 1e-9).sum())
        print(f"   {pol} / gd ACME: median {med:.6f} (limit 1.001), max "
              f"{float(r[fin].max()):.6f}, {above} voxels above x1.02 "
              f"(limit {b // 1000}), share <= x1.001 "
              f"{float((r[fin] <= 1.001).double().mean()):.5f}, share < x1 "
              f"{float((r[fin] < 1.0).double().mean()):.5f}; max |p0| "
              f"{polish_p[pol][0]:.3f}, max |p1| {polish_p[pol][1]:.3f}; K5 "
              f"not launched", flush=True)
        if (not torch.equal(fin, torch.isfinite(polish_scores["gd"]))
                or med > 1.001 or above > b // 1000):
            raise AssertionError(f"{pol}: scores above the gd polish's")
    del polish_scores, u_re, u_im
    torch.cuda.empty_cache()

    # ---- 4v. the ROI methods ----
    _phase("4v autophase(method=peak_minima / positivity), p0 only, "
           "peak_width 200 Hz")
    spec_da = XmrArray(
        torch.complex(un_re, un_im).reshape(bi.GRID + (bi.ZERO_FILL,)),
        dims=("x", "y", "z", "frequency"),
        coords={"frequency": Coord("frequency", f_m64)})
    roi = {}
    for method in ("peak_minima", "positivity"):
        for mode, opt in (("single", "grid"), ("single", "de"),
                          ("all", "grid")):
            K.reset_counters()
            t0 = time.perf_counter()
            o = autophase(spec_da, method=method, mode=mode, optimizer=opt,
                          p0_only=True, peak_width=200.0)
            _sync()
            dt_s = time.perf_counter() - t0
            counts = K.counters()
            if any(counts["launches"].values()) or any(
                    counts["plain_calls"].values()):
                raise AssertionError(f"{method} {mode} {opt}: launches "
                                     f"{counts}")
            p0v = np.asarray(o.attrs["phase_p0"], dtype=np.float64)
            if not (np.isfinite(p0v).all() and torch.isfinite(o.data).all()
                    and np.all(np.asarray(o.attrs["phase_p1"]) == 0.0)):
                raise AssertionError(f"{method} {mode} {opt}: not finite")
            roi[f"{method} {mode} {opt}"] = dt_s
            print(f"   {method}, {mode}, {opt}: {dt_s:.3f} s, p0 "
                  + (f"{float(p0v):.4f}" if mode == "single" else
                     f"median {float(np.median(p0v)):.4f}") + ", no kernel",
                  flush=True)
            del o
    v_piv = int(torch.argmax(mv_m))
    row_da = XmrArray(torch.complex(un_re[v_piv], un_im[v_piv]).cpu().numpy(),
                      dims=("frequency",),
                      coords={"frequency": Coord("frequency", f_m64)})
    t0 = time.perf_counter()
    o = autophase(row_da, optimizer="scipy")
    scipy_s = time.perf_counter() - t0
    print(f"   scipy (ACME, p0 + p1) on the pivot row: {scipy_s:.3f} s, "
          f"(p0, p1) = ({o.attrs['phase_p0']:.4f}, {o.attrs['phase_p1']:.4f})")
    del spec_da
    torch.cuda.empty_cache()

    # ---- 4w. AsLS baseline on the grid (CR, float64 on the card) ----
    _phase("4w als_baseline_batched on the 16 384 x 2048 real spectra")
    sr_m, _, _ = spectral_pipeline_planar_raw(re, im, w_m, f_m,
                                              mrsi_cfgs["grid search"])
    rows64 = sr_m.double()
    asls = dict(lam=1e5, p=0.001, n_iter=10)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    z = als_baseline_batched(rows64, **asls)
    _sync()
    asls_first_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if z.dtype != torch.float64 or not torch.isfinite(z).all():
        raise AssertionError("AsLS: not finite float64")
    idx = torch.linspace(0, b - 1, 64, device=dev).round().long()
    t0 = time.perf_counter()
    z_scan = als_baseline_batched(rows64[idx].cpu(), solver="scan", **asls)
    scan_s = time.perf_counter() - t0
    err = float((z[idx].cpu() - z_scan).abs().max())
    lim = 1e-7 * float(z_scan.abs().max())
    print(f"   CR on the card: {asls_first_s:.3f} s (first call), peak "
          f"{peak_gb:.2f} GiB; vs the CPU scan on 64 voxels ({scan_s:.2f} s): "
          f"max|err| {err:.3e}, limit {lim:.3e}", flush=True)
    if not err <= lim:
        raise AssertionError("AsLS CR differs from the scan")
    z32 = als_baseline_batched(sr_m, **asls)
    _sync()
    if z32.dtype != torch.float32 or torch.isnan(z32).any():
        raise AssertionError("AsLS on float32 input: NaN or wrong dtype")
    print("   float32 input: float32 out, no NaN")
    del z, z32, z_scan, rows64
    torch.cuda.empty_cache()

    # ---- 4x. multi-coil k-space to maps: recon -> mrsi_pipeline -> fit ----
    _phase("4x k-space recon of an 8-coil (coil, kx, ky, kz, time) grid, "
           "then mrsi_pipeline and .xmr.fit_amares on the card")
    torch.cuda.reset_peak_memory_stats()
    grid_t = torch.as_tensor(fids, device=dev).reshape(bi.GRID + (bi.N_TIME,))
    maps_np = bi.unit_rss_coil_maps(bi.GRID, bi.N_COILS)
    maps_t = torch.as_tensor(maps_np.astype(np.complex64), device=dev)
    sp = (1, 2, 3)
    ksp = torch.fft.fftshift(torch.fft.fftn(torch.fft.ifftshift(
        maps_t[..., None] * grid_t[None], dim=sp), dim=sp, norm="ortho"), dim=sp)
    ksp_da = XmrArray(ksp, dims=("coil", "kx", "ky", "kz", "time"),
                      coords={"time": Coord("time", t_np.astype(np.float64))},
                      attrs={"MHz": bi.MHZ})
    _sync()
    print(f"   k-space {tuple(ksp.shape)} {ksp.dtype}, "
          f"{ksp.numel() * ksp.element_size() / 2**30:.3f} GiB on the card")
    fid_scale = float(grid_t.abs().max())
    # 1. centered iFFT, SENSE combine with the true maps (broadcast over time).
    img = kspace_to_image(ksp_da)
    sens_da = XmrArray(maps_t[..., None].expand(img.shape), dims=img.dims)
    rec = sense_combine(img, sens_da)
    _sync()
    if rec.dims != ("x", "y", "z", "time") or not rec.data.is_cuda:
        raise AssertionError(f"SENSE recon: dims {rec.dims}, off the card")
    sense_err = _assert_close("SENSE recon vs the bench FIDs re", rec.data.real,
                              grid_t.real, 0.0, 1e-5 * fid_scale)
    sense_err = max(sense_err, _assert_close(
        "SENSE recon vs the bench FIDs im", rec.data.imag, grid_t.imag, 0.0,
        1e-5 * fid_scale))
    # 2. RSS of unit-RSS maps times the FIDs is |FID|.
    rss = rss_reconstruct(ksp_da)
    rss_err = _assert_close("RSS recon vs |FID|", rss.data, grid_t.abs(), 0.0,
                            1e-5 * fid_scale)
    del rss
    # 3. maps from the first time point, inside the object's interior: the
    # central ellipsoid at a fifth of each axis (every voxel holds signal).
    est = estimate_sensitivities(ksp_da.isel(time=0))
    axes_s, big = bi.scaled_grid(bi.GRID)
    interior = torch.as_tensor(
        sum((a - big / 2) ** 2 for a in axes_s) < (big / 5) ** 2, device=dev)
    map_err = float((est.data - maps_t).abs()[:, interior].mean())
    print(f"   maps from time 0 (calib_frac 0.25) vs the true maps in the "
          f"interior ({int(interior.sum())} voxels): mean |err| {map_err:.5f} "
          f"(limit < 0.05)", flush=True)
    if not map_err < 0.05:
        raise AssertionError("estimated sensitivity maps off the true maps")
    del est
    # 4. mrsi_pipeline on the recon'd grid, still on the card, against phase
    # 4s's grid-search call on the phantom's own planes.  The single-pivot
    # search sits in a flat p0-p1 valley, where data one float32 rounding
    # away may settle elsewhere: the spectra are held after turning 4s's onto
    # this run's phases, and the phases by the ACME score they reach.
    out_r = _mrsi_run(K, mrsi_pipeline, rec, mrsi_cfgs["grid search"],
                      "mrsi_pipeline", 1)
    if not out_r.data.is_cuda:
        raise AssertionError("mrsi_pipeline left the card on a tensor payload")
    out_4s = mrsi_out["grid search"]
    ref_s = torch.as_tensor(out_4s.values, device=dev)
    s_scale = float(ref_s.abs().max())
    f_4s = torch.as_tensor(out_4s.coords["frequency"].values, device=dev,
                           dtype=torch.float64)

    def _factor(o):
        return phase_factor_raw(f_4s, float(o.attrs["phase_p0"]),
                                float(o.attrs["phase_p1"]),
                                float(o.attrs["phase_pivot"]),
                                float(f_4s.max() - f_4s.min()))

    turned = ref_s * (_factor(out_r) / _factor(out_4s)).to(ref_s.dtype)
    raw_err = float((out_r.data - ref_s).abs().max())
    print(f"   unturned spectra: max|err| {raw_err:.3e} ({raw_err / s_scale:.3e} "
          f"of max|S|, reported)")
    spec_err = max(
        _assert_close("recon'd mrsi_pipeline spectra vs 4s's turned re",
                      out_r.data.real, turned.real, 0.0, 1e-4 * s_scale),
        _assert_close("recon'd mrsi_pipeline spectra vs 4s's turned im",
                      out_r.data.imag, turned.imag, 0.0, 1e-4 * s_scale))
    piv_v = np.unravel_index(int(torch.argmax(ref_s.abs())), tuple(ref_s.shape))[:3]
    acme_r, acme_4s = (float(acme_score_raw(s[piv_v].real.double()[None])[0])
                       for s in (out_r.data, ref_s))
    acme_ratio = acme_r / acme_4s
    print(f"   phases (p0, p1): recon'd ({out_r.attrs['phase_p0']:.5f}, "
          f"{out_r.attrs['phase_p1']:.5f}), 4s ({out_4s.attrs['phase_p0']:.5f}, "
          f"{out_4s.attrs['phase_p1']:.5f}); ACME of the pivot "
          f"row {acme_r:.9e} vs {acme_4s:.9e}, ratio {acme_ratio:.7f} (limit "
          f"x1.001 both ways)", flush=True)
    if not 1 / 1.001 <= acme_ratio <= 1.001:
        raise AssertionError("recon'd mrsi_pipeline: ACME off phase 4s's")
    del out_r, ref_s, turned
    # 5. .xmr.fit_amares on the recon'd grid, its planes staged from the card.
    flat = rec.data.reshape(b, bi.N_TIME)
    K.reset_counters()
    t0 = time.perf_counter()
    ds_r = rec.xmr.fit_amares(pk, device_fids=(flat.real.contiguous(),
                                               flat.imag.contiguous()))
    _sync()
    fit_r_s = time.perf_counter() - t0
    counts = K.counters()
    _check_path(K, counts, "fit_amares")
    fit_r_launches = {n: counts["launches"][n] for n in K.PATHS["fit_amares"]}
    print(f"   .xmr.fit_amares launches: {fit_r_launches}")
    conv_r = float(ds_r["fit_converged"].values.mean())
    pcr_r = float(np.median(np.abs(ds_r["amplitude"].values.reshape(b, -1)[:, 0]
                                   - bi.pcr_amplitudes()) / bi.pcr_amplitudes()))
    got_r = np.stack([ds_r[n].values.reshape(b, -1) for n in fams])
    maps_4c = np.stack([ds[n].values.reshape(b, -1) for n in fams])
    crlb_ratio = (np.abs(got_r - maps_4c) / (2e-3 + 0.1 * sd)).max(axis=(0, 2))
    crlb_share = float((crlb_ratio <= 1.0).mean())
    print(f"   .xmr.fit_amares in {fit_r_s:.3f} s: converged {conv_r:.4f} (limit "
          f">= 0.95), PCr median rel err {pcr_r:.5f} (limit <= 0.05), "
          f"{crlb_share:.5f} of voxels within 2e-3 + 0.1 CRLB of 4c's maps "
          f"(limit >= 0.995; max ratio {float(crlb_ratio.max()):.3f})", flush=True)
    if conv_r < 0.95 or not pcr_r <= 0.05 or crlb_share < 0.995:
        raise AssertionError(".xmr.fit_amares on the recon'd grid failed")
    del ds_r, got_r, maps_4c, flat
    # 6. BASELINE config 3: 8 coils x 256 x 256, tests/test_recon.py's phantom.
    k3, ph3, sens3 = bi.coil_kspace_phantom((256, 256), bi.N_COILS)
    img64 = np.fft.fftshift(np.fft.ifftn(np.fft.ifftshift(k3, axes=(1, 2)),
                                         axes=(1, 2), norm="ortho"), axes=(1, 2))
    rss64 = torch.as_tensor(np.sqrt(np.sum(np.abs(img64) ** 2, axis=0)), device=dev)
    k3_da = XmrArray(torch.as_tensor(k3.astype(np.complex64), device=dev),
                     dims=("coil", "ky", "kx"))
    rss3 = rss_reconstruct(k3_da)
    rss3_err = _assert_close("config 3 RSS vs float64 numpy", rss3.data, rss64,
                             0.0, 1e-5 * float(rss64.max()))
    mask3 = torch.as_tensor(ph3 > 0.5, device=dev)
    sense3 = sense_reconstruct(k3_da, calib_frac=0.4)
    expected3 = torch.as_tensor(ph3 * np.sqrt(np.sum(np.abs(sens3) ** 2, axis=0)),
                                device=dev)
    sense3_rel = float(((sense3.data.abs() - expected3).abs()[mask3]
                        / expected3[mask3].max()).mean())
    print(f"   config 3 SENSE (calib_frac 0.4): mean |(|x| - truth)| / max "
          f"{sense3_rel:.5f} in the object (limit < 0.05)", flush=True)
    if not sense3_rel < 0.05:
        raise AssertionError("config 3 SENSE recon off the phantom")
    img3 = kspace_to_image(k3_da).data
    a_re, a_im = adaptive_combine_planar_raw(img3.real, img3.imag)
    adapt_rel = float(((torch.sqrt(a_re**2 + a_im**2) - rss64).abs()
                       / rss64)[mask3].max())
    print(f"   config 3 adaptive combine: max |mag - RSS| / RSS {adapt_rel:.5f} "
          f"in the object (limit <= 0.02)", flush=True)
    if not adapt_rel <= 0.02:
        raise AssertionError("config 3 adaptive combine off RSS")
    # 7. BASELINE config 1, the accessor Quick Start on the card.
    qs_kw = dict(amplitudes=[10.0, 3.0], chemical_shifts=[4.7, 1.3],
                 reference_frequency=127.6, carrier_ppm=4.7, spectral_width=5000.0,
                 n_points=1024, dampings=[30.0, 20.0], target_snr=50.0)
    qs = [simulate_fid(**qs_kw, seed=s) for s in range(5)]
    qs_da = XmrArray(np.stack([q.values for q in qs]), dims=("voxel", "time"),
                     coords={"time": qs[0].coords["time"]}, attrs=qs[0].attrs)
    qs_out = (qs_da.to(dev).xmr.zero_fill(target_points=2048)
              .xmr.apodize_exp(lb=5.0).xmr.to_spectrum().xmr.autophase()
              .xmr.to_ppm())
    ppm = qs_out.coords["chemical_shift"].values
    peaks = ppm[np.argmax(np.abs(qs_out.values), axis=1)]
    print(f"   Quick Start (5 voxels, DE autophase on the card): peaks at "
          f"{peaks.round(4).tolist()} ppm (4.7 within one bin, "
          f"{abs(ppm[1] - ppm[0]):.4f} ppm); p0 {qs_out.attrs['phase_p0']:.3f}",
          flush=True)
    if not qs_out.data.is_cuda or np.abs(peaks - 4.7).max() > abs(ppm[1] - ppm[0]):
        raise AssertionError("Quick Start: off the card or the peak moved")
    # Each step in turns: 5 rounds, the order reversed every other round.
    recon_calls = {
        "kspace_to_image (8 coils, 1 GiB)": lambda: kspace_to_image(ksp_da),
        "sense_combine": lambda: sense_combine(img, sens_da),
        "rss_reconstruct": lambda: rss_reconstruct(ksp_da),
        "estimate_sensitivities, time 0": lambda: estimate_sensitivities(
            ksp_da.isel(time=0)),
        "k-space to spectra (kspace_to_image, sense_combine, mrsi_pipeline)":
            lambda: mrsi_pipeline(sense_combine(kspace_to_image(ksp_da), sens_da),
                                  cfg=mrsi_cfgs["grid search"]),
        "k-space host copy (1 GiB, pageable)": lambda: ksp.cpu(),
        "config 3 rss_reconstruct": lambda: rss_reconstruct(k3_da),
        "config 3 sense_reconstruct": lambda: sense_reconstruct(
            k3_da, calib_frac=0.4),
        "config 3 adaptive_combine_planar_raw": lambda: adaptive_combine_planar_raw(
            img3.real, img3.imag),
    }
    recon_turns = {k: [] for k in recon_calls}
    for rnd in range(5):
        names = list(recon_calls) if rnd % 2 == 0 else list(recon_calls)[::-1]
        for name in names:
            _sync()
            t0 = time.perf_counter()
            recon_calls[name]()
            _sync()
            recon_turns[name].append(1e3 * (time.perf_counter() - t0))
    recon_ms = {k: float(np.median(v)) for k, v in recon_turns.items()}
    for name, xs in recon_turns.items():
        print(f"   in turns, {name}: median {recon_ms[name]:.3f} ms "
              f"({', '.join(f'{x:.3f}' for x in xs)})")
    recon_peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if profile_dir:
        _profile(kspace_to_image, (ksp_da,), {},
                 recon_ms["kspace_to_image (8 coils, 1 GiB)"], profile_dir,
                 "kspace_to_image, 1 GiB", "profile_kspace.txt")
        _profile(recon_calls["k-space to spectra (kspace_to_image, "
                             "sense_combine, mrsi_pipeline)"], (), {},
                 recon_ms["k-space to spectra (kspace_to_image, sense_combine, "
                          "mrsi_pipeline)"], profile_dir,
                 "k-space to spectra", "profile_kspace_to_spectra.txt")
    print(f"   peak device memory over 4x: {recon_peak_gb:.2f} GiB", flush=True)
    slice12 = {
        "ms_in_turns": recon_ms, "peak_gib": recon_peak_gb,
        "sense_max_err": sense_err, "rss_max_err": rss_err,
        "fid_max_abs": fid_scale, "map_mean_err": map_err,
        "pipeline_spectra_max_err": spec_err, "spectra_max_abs": s_scale,
        "pipeline_unturned_max_err": raw_err,
        "pipeline_acme_ratio": acme_ratio, "fit_amares_s": fit_r_s,
        "fit_launches": fit_r_launches,
        "fit_converged": conv_r, "fit_pcr_err": pcr_r,
        "fit_share_within_0.1_crlb_of_4c": crlb_share,
        "config3_rss_max_err": rss3_err, "config3_sense_rel": sense3_rel,
        "config3_adaptive_rel": adapt_rel, "quickstart_peaks_ppm": peaks.tolist()}
    del ksp, ksp_da, rec, img, sens_da, img3, k3_da, grid_t, recon_calls
    torch.cuda.empty_cache()

    # ---- 4y. the voxel mesh on one card, the CLIs and the profiler ----
    _phase("4y the voxel mesh (cuda:0 repeated), the fit/recon/serve CLIs "
           "and the profiler")
    slice13 = {"not_bit_equal": {}}
    mesh1, mesh4 = Mesh([dev]), Mesh([dev] * 4)

    def _grid_dict(out):
        sr_, si_, ph_, x_, cost_, conv_, sds_ = out
        return {"spec_re": sr_, "spec_im": si_, "p0": ph_[0], "p1": ph_[1],
                "pivot": ph_[2], "x_free": x_, "cost": cost_,
                "converged": conv_, "crlb": sds_}

    def _diff_names(got, ref):
        return [k for k in ref if not (
            _same_bits(got[k], ref[k]) if got[k].is_floating_point()
            else torch.equal(got[k], ref[k]))]

    def _shard_sums(call, tensors, n_sh, names):
        """Each shard's launches of ``names``, ``call(*its slices)`` run
        alone on its voxels (``tensors`` split as ``shard_voxels`` splits
        them), summed over the shards: what the sharded call must launch
        when every shard's LM loop exits on its own voxels."""
        tot = dict.fromkeys(names, 0)
        for parts in zip(*(x.chunk(n_sh) for x in tensors)):
            K.reset_counters()
            call(*parts)
            _sync()
            lc_s = K.counters()["launches"]
            for n in names:
                tot[n] += lc_s[n]
        return tot

    # (a) process_grid_sharded at 1 and 4 shards against the one-device
    # program: K1 works voxel by voxel and the phase is solved once on the
    # same row, so spectra and phases are bit for bit; the fit's outputs
    # are bit for bit where the seed's matrix products round alike at the
    # shard's batch, else held at phase 4's kernel-vs-plain bars.  K2 runs
    # once per LM iteration of each shard and once at its start, K3 once
    # per iteration: the sharded call's counts must be the sums of each
    # shard's fit run alone.
    lm_names = ("eq6_normal_eq_v9", "spd_solve_damped")
    fit_alone = {n_sh: _shard_sums(
        lambda re_s, im_s: seeded_fit_grid_raw(
            re_s, im_s, t_d, xt_d, lower, upper, kind,
            **{k: v for k, v in fit_kw.items() if k != "cfg"}),
        (re, im), n_sh, lm_names) for n_sh in (1, 4)}
    print(f"   the seeded fit's LM launches, each shard alone, summed: "
          f"{fit_alone}", flush=True)
    for tag, kw, path in (("single", fit_kw, "grid_single_pivot"),
                          ("all", fit_kw_all, "grid_per_voxel")):
        ref_g = _grid_dict(process_grid_planar_raw(*args, **kw))
        _sync()
        per_shard = ("spectrum", "spd_inverse_diag") + (
            ("acme_polish",) if tag == "all" else ())
        for n_sh, mesh in ((1, mesh1), (4, mesh4)):
            K.reset_counters()
            got_g = _grid_dict(process_grid_sharded(*args, mesh=mesh, **kw))
            _sync()
            counts = K.counters()
            _check_path(K, counts, path)
            lc = counts["launches"]
            for name in per_shard:
                if lc[name] != n_sh:
                    raise AssertionError(f"sharded {tag}: {name} launched "
                                         f"{lc[name]} times, not {n_sh}")
            for name in lm_names:
                if lc[name] != fit_alone[n_sh][name]:
                    raise AssertionError(
                        f"sharded {tag}: {name} launched {lc[name]} times on "
                        f"{n_sh} shards, not the shards' "
                        f"{fit_alone[n_sh][name]}")
            diff = _diff_names(got_g, ref_g)
            print(f"   sharded grid, autophase={tag}, {n_sh} shard(s): launches "
                  f"{ {n: lc[n] for n in K.PATHS[path]} }; not bit for bit: "
                  f"{diff or 'none'}", flush=True)
            if set(diff) & {"spec_re", "spec_im", "p0", "p1", "pivot"}:
                raise AssertionError(f"sharded {tag}: spectra or phases differ")
            if diff:
                slice13["not_bit_equal"][f"grid_{tag}_{n_sh}"] = diff
                _within_crlb(f"sharded {tag} x_free", got_g["x_free"],
                             ref_g["x_free"], ref_g["crlb"])
                _share_within(f"sharded {tag} cost", got_g["cost"][:, None],
                              ref_g["cost"][:, None], 1e-5, 0.0, 0.99)
                _share_within(f"sharded {tag} CRLB", got_g["crlb"],
                              ref_g["crlb"], 2e-2, 1e-4, 0.99)
            if float(got_g["converged"].float().mean()) < 0.95:
                raise AssertionError(f"sharded {tag}: converged share < 0.95")
        del ref_g, got_g
    grid_calls = {
        "unsharded": lambda: process_grid_planar_raw(*args, **fit_kw),
        "1 shard": lambda: process_grid_sharded(*args, mesh=mesh1, **fit_kw),
        "4 shards": lambda: process_grid_sharded(*args, mesh=mesh4, **fit_kw),
    }
    grid_turns = {k: [] for k in grid_calls}
    for rnd in range(6):
        for name in (list(grid_calls) if rnd % 2 == 0 else list(grid_calls)[::-1]):
            _sync()
            t0 = time.perf_counter()
            grid_calls[name]()
            _sync()
            grid_turns[name].append(1e3 * (time.perf_counter() - t0))
    slice13["grid_ms_in_turns"] = {k: float(np.median(v))
                                   for k, v in grid_turns.items()}
    for name, xs in grid_turns.items():
        print(f"   in turns, single-pivot grid {name}: median "
              f"{slice13['grid_ms_in_turns'][name]:.3f} ms "
              f"({', '.join(f'{x:.1f}' for x in xs)})", flush=True)

    # (b) the sharded LM at kernel_version 8 (K9 + K6a) and 10 (K8) on the
    # bench seeds, against the single launch.
    lm_args = (re, im, t_d, u0, lower, upper, kind, ps, bi.MHZ)
    for v, path_kernels in ((8, ("eq6_normal_eq_v8", "spd_solve_damped_dense")),
                            (10, ("lm_loop_v10",))):
        one_r, one_h = lm_fit_batched_pallas(
            *lm_args, max_iter=24, kernel_version=v, require_uniform_t=True,
            return_hessian=True)
        K.reset_counters()
        sh_r, sh_h = lm_fit_batched_pallas_sharded(
            *lm_args, mesh=mesh4, max_iter=24, kernel_version=v,
            return_hessian=True)
        _sync()
        counts = K.counters()
        lc = counts["launches"]
        if any(counts["plain_calls"].values()) or any(
                lc[n] for n in lc if n not in path_kernels):
            raise AssertionError(f"sharded v{v}: another kernel or a plain "
                                 f"version ran: {counts}")
        alone = _shard_sums(
            lambda re_s, im_s, u_s: lm_fit_batched_pallas(
                re_s, im_s, t_d, u_s, lower, upper, kind, ps, bi.MHZ,
                max_iter=24, kernel_version=v, require_uniform_t=True,
                return_hessian=True),
            (re, im, u0), 4, path_kernels)
        if any(lc[n] != alone[n] for n in path_kernels) or (
                v == 10 and lc["lm_loop_v10"] != 4):
            raise AssertionError(f"sharded v{v}: launches {lc}, not the "
                                 f"shards' {alone}")
        got_l = {"x_free": sh_r.x_free, "cost": sh_r.cost, "n_iter": sh_r.n_iter,
                 "converged": sh_r.converged, "hessian": sh_h}
        ref_l = {"x_free": one_r.x_free, "cost": one_r.cost,
                 "n_iter": one_r.n_iter, "converged": one_r.converged,
                 "hessian": one_h}
        diff = _diff_names(got_l, ref_l)
        print(f"   sharded LM v{v}, 4 shards: launches "
              f"{ {n: lc[n] for n in path_kernels} }; not bit for bit: "
              f"{diff or 'none'}", flush=True)
        if diff:
            slice13["not_bit_equal"][f"lm_v{v}_4"] = diff
            _share_within(f"sharded LM v{v} x_free", sh_r.x_free, one_r.x_free,
                          1e-4, 1e-4, 0.99)
            _share_within(f"sharded LM v{v} cost", sh_r.cost[:, None],
                          one_r.cost[:, None], 1e-5, 0.0, 0.99)
        slice13[f"lm_v{v}_launches"] = {n: lc[n] for n in path_kernels}
        del one_r, one_h, sh_r, sh_h, got_l, ref_l

    maps_4c = np.stack([ds[n].values.reshape(b, -1) for n in fams])

    def _held_to_4c(name, ds_got):
        """The maps of ``ds_got`` against 4c's: bit for bit, or every voxel
        within 2e-3 + 0.1 CRLB; converged >= 0.95, PCr error <= 0.05."""
        got = np.stack([ds_got[n].values.reshape(b, -1) for n in fams])
        same = (np.array_equal(got, maps_4c)
                and np.array_equal(ds_got["crlb"].values, ds["crlb"].values)
                and np.array_equal(ds_got["fit_converged"].values,
                                   ds["fit_converged"].values))
        ratio = float((np.abs(got - maps_4c) / (2e-3 + 0.1 * sd)).max())
        conv = float(ds_got["fit_converged"].values.mean())
        pcr = float(np.median(np.abs(got[0][:, 0] - bi.pcr_amplitudes())
                              / bi.pcr_amplitudes()))
        print(f"   {name}: maps bit for bit 4c's: {same}; max |d| / (2e-3 + 0.1 "
              f"CRLB) {ratio:.3f} (limit 1); converged {conv:.4f} (limit >= "
              f"0.95); PCr median rel err {pcr:.5f} (limit <= 0.05)", flush=True)
        if not (same or ratio <= 1.0) or conv < 0.95 or not pcr <= 0.05:
            raise AssertionError(f"{name}: maps off phase 4c's")
        if not same:
            slice13["not_bit_equal"][name] = "maps"
        return same

    # (c) fit_amares over 4 shards of one card (K2 + K3 per shard, K6b once
    # on the gathered Hessian).
    K.reset_counters()
    ds_m = fit_amares(da, pk, mesh=mesh4, return_curves=False)
    _sync()
    counts = K.counters()
    _check_path(K, counts, "fit_amares")
    lc = counts["launches"]
    if lc["spd_inverse_diag_dense"] != 1 or lc["eq6_normal_eq_v9"] < 8:
        raise AssertionError(f"fit_amares(mesh=4 shards): launches {lc}")
    slice13["fit_amares_mesh4_launches"] = {n: lc[n] for n in K.PATHS["fit_amares"]}
    print(f"   fit_amares(mesh=4 shards) launches "
          f"{slice13['fit_amares_mesh4_launches']}")
    slice13["fit_amares_mesh4_bit_equal"] = _held_to_4c("fit_amares(mesh=4 shards)",
                                                        ds_m)
    del ds_m
    fit_turns = {"unsharded": [], "4 shards": []}
    for rnd in range(3):
        for name in (("unsharded", "4 shards") if rnd % 2 == 0
                     else ("4 shards", "unsharded")):
            _sync()
            t0 = time.perf_counter()
            fit_amares(da, pk, return_curves=False,
                       mesh=mesh4 if name == "4 shards" else None)
            _sync()
            fit_turns[name].append(time.perf_counter() - t0)
    slice13["fit_amares_s_in_turns"] = {k: float(np.median(v))
                                        for k, v in fit_turns.items()}
    print(f"   in turns, fit_amares(return_curves=False) s: "
          f"{ {k: [round(x, 3) for x in v] for k, v in fit_turns.items()} }",
          flush=True)

    # (d) the server: 3 bench grids (128 MiB each) in a temporary directory,
    # drained once serially and once with --pipeline.
    tmp = Path(tempfile.mkdtemp(prefix="xmt_smoke_"))
    try:
        watch = tmp / "in"
        watch.mkdir()
        pk_path = tmp / "pk.csv"
        pk_path.write_text(bi.PK_CSV)
        for i in range(3):
            save_npz(da, watch / f"grid{i}.npz")
        serve = {}
        for mode, extra in (("serial", []), ("pipeline", ["--pipeline"])):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.serve_main([str(watch), str(pk_path), "-o",
                                     str(tmp / f"out_{mode}"), "--once",
                                     "--state-file", str(tmp / f"{mode}.state")]
                                    + extra)
            total = time.perf_counter() - t0
            records = [json.loads(ln) for ln in buf.getvalue().splitlines()
                       if ln.startswith("{")]
            walls = [r.get("wall_s") for r in records]
            print(f"   serve --once {mode}: exit {rc}, {len(records)} records, "
                  f"wall_s per grid {walls}, drained in {total:.3f} s", flush=True)
            if len(records) != 3 or any(r["status"] != "ok"
                                        or r["converged_frac"] < 0.95
                                        for r in records):
                raise AssertionError(f"serve {mode}: records {records}")
            all_conv = True
            for r in records:
                ds_r = load_dataset_npz(tmp / f"out_{mode}" / r["output"])
                all_conv &= bool(ds_r["fit_converged"].values.all())
                _held_to_4c(f"serve {mode} {r['file']}", ds_r)
            # --once exits 2 where a grid left an unconverged voxel.
            if rc != (0 if all_conv else 2):
                raise AssertionError(f"serve {mode}: exit {rc} with every "
                                     f"voxel converged: {all_conv}")
            serve[mode] = {"rc": rc, "wall_s": walls, "drain_s": total,
                           "records": [{k: v for k, v in r.items()
                                        if k != "wall_s"} for r in records],
                           "ledger": (tmp / f"{mode}.state").read_text().split()}
        if any(serve["serial"][k] != serve["pipeline"][k]
               for k in ("rc", "records", "ledger")):
            raise AssertionError("serve: --pipeline differs from serial")
        slice13["serve"] = {m: {k: serve[m][k] for k in ("rc", "wall_s", "drain_s")}
                            for m in serve}

        # (e) the other two CLIs: fit_main on one grid, recon_main on
        # BASELINE config 3 against phase 4x's API results.
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.fit_main([str(watch / "grid0.npz"), str(pk_path), "-o",
                               str(tmp / "fit.npz")])
        summary = json.loads([ln for ln in buf.getvalue().splitlines()
                              if ln.startswith("{")][-1])
        ds_fit = load_dataset_npz(tmp / "fit.npz")
        want_rc = 0 if ds_fit["fit_converged"].values.all() else 2
        print(f"   fit_main: exit {rc} (expected {want_rc}), {summary}",
              flush=True)
        if rc != want_rc:
            raise AssertionError(f"fit_main: exit {rc}, not {want_rc}")
        _held_to_4c("fit_main", ds_fit)
        del ds_fit
        slice13["fit_main"] = {"rc": rc, "fit_s": summary["fit_s"],
                               "load_s": summary["load_s"]}
        save_npz(XmrArray(k3.astype(np.complex64), dims=("coil", "ky", "kx")),
                 tmp / "k3.npz")
        slice13["recon_main"] = {}
        for combine, extra, want in (("rss", [], rss3), ("sense",
                                     ["--calib-frac", "0.4"], sense3)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.recon_main([str(tmp / "k3.npz"), "-o",
                                     str(tmp / f"{combine}.npz"), "--combine",
                                     combine] + extra)
            got = load_npz(tmp / f"{combine}.npz")
            ref = want.data.cpu().numpy()
            same = got.dims == want.dims and np.array_equal(got.values, ref)
            err = float(np.abs(got.values - ref).max())
            print(f"   recon_main --combine {combine}: exit {rc}, dims "
                  f"{got.dims}, bit for bit 4x's {combine}: {same} (max|err| "
                  f"{err:.3e}, limit 1e-6 of max {float(np.abs(ref).max()):.3e})",
                  flush=True)
            if rc != 0 or got.dims != want.dims or not err <= 1e-6 * float(
                    np.abs(ref).max()):
                raise AssertionError(f"recon_main {combine} off phase 4x's")
            slice13["recon_main"][combine] = {"bit_equal": same, "max_err": err}

        # (f) the profiler: one grid's two stages under
        # runtime.profiling.trace, each timed by stage_timer.
        timings = Timings()
        with trace(tmp / "trace") as trace_dir:
            with stage_timer(timings, "spectral stage", re):
                spectral_pipeline_planar_raw(re, im, w_d, f_d, cfg)
            with stage_timer(timings, "seeded fit + CRLB", re):
                seeded_fit_grid_raw(re, im, t_d, xt_d, lower, upper, kind,
                                    **{k: v for k, v in fit_kw.items()
                                       if k != "cfg"})
        files = sorted(trace_dir.glob("trace_*.json"))
        text = files[-1].read_text() if files else ""
        names = {"K1": "spectrum_fft_kernel", "K2": "normal_eq_warp_kernel",
                 "K3/K4": "spd_"}
        found = {k: n in text for k, n in names.items()}
        print(f"   trace {files[-1].name if files else None}: "
              f"{len(text) / 2**20:.1f} MiB, kernels named {found}", flush=True)
        if not files or not all(found.values()):
            raise AssertionError("the trace does not name the path's kernels")
        print(timings.report(), flush=True)
        slice13["profile_stages_ms"] = {k: 1e3 * v
                                        for k, v in timings.stages.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- 4z. item 13: the grid's spectra and fit to figures and widgets ----
    _phase("4z mrsi_pipeline and .xmr.fit_amares on a CUDA payload, then the "
           "plots and widgets drawn from what the card returned")
    import importlib.util

    from xmris_tpu_torch.core import array as carrier
    from xmris_tpu_torch.core.array import XmrDataset
    from xmris_tpu_torch.visualization import _host
    from xmris_tpu_torch.visualization.plot import PlotQCGridConfig

    # matplotlib and traitlets are the optional viz/widgets extras: where
    # they are missing, the figures' and widgets' host data (the ops where
    # the payload lies, then the copies) are built and checked instead.
    missing = [m for m in ("matplotlib", "traitlets", "IPython")
               if importlib.util.find_spec(m) is None]
    has_mpl = "matplotlib" not in missing
    has_widgets = "traitlets" not in missing
    print(f"   optional extras missing: {missing or 'none'}; figures "
          f"{'drawn' if has_mpl else 'not drawn, their host data checked'}, "
          f"widgets {'built' if has_widgets else 'not built, their traits checked'}",
          flush=True)
    if has_mpl:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.collections import QuadMesh
        from matplotlib.colors import to_rgba
    if has_widgets:
        from xmris_tpu_torch.visualization import widget as xwidget
    slice14 = {"missing": missing, "card": smi}

    # 1-2. the bench grid as a CUDA payload through mrsi_pipeline (one K1).
    grid_da = XmrArray(torch.as_tensor(fids, device=dev).reshape(bi.GRID + (bi.N_TIME,)),
                       dims=("x", "y", "z", "time"),
                       coords={"time": Coord("time", t_np.astype(np.float64))},
                       attrs={"MHz": bi.MHZ})
    t0 = time.perf_counter()
    spec = _mrsi_run(K, mrsi_pipeline, grid_da, mrsi_cfgs["grid search"],
                     "mrsi_pipeline", 1)
    slice14["mrsi_pipeline_s"] = time.perf_counter() - t0
    if spec.data.device != dev or spec.dims != ("x", "y", "z", "frequency"):
        raise AssertionError(f"mrsi_pipeline: dims {spec.dims} on {spec.data.device}")
    got_s, ref_s4 = spec.values, mrsi_out["grid search"].values
    s_err = float(np.abs(got_s - ref_s4).max())
    slice14["spectra_bit_equal_4s"] = bool(np.array_equal(got_s, ref_s4))
    print(f"   mrsi_pipeline (grid search) on the CUDA payload vs 4s's on the "
          f"host payload: bit for bit {slice14['spectra_bit_equal_4s']}, max|err| "
          f"{s_err:.3e} (limit 1e-6 of max|S| {float(np.abs(ref_s4).max()):.3e})")
    if not s_err <= 1e-6 * float(np.abs(ref_s4).max()):
        raise AssertionError("mrsi_pipeline on a CUDA payload off 4s's")
    del got_s, ref_s4

    # 3. .xmr.fit_amares on the CUDA FIDs (K2, K3, K6b), held to 4c's maps.
    K.reset_counters()
    t0 = time.perf_counter()
    ds_z = grid_da.xmr.fit_amares(pk)
    _sync()
    slice14["fit_amares_s"] = time.perf_counter() - t0
    counts = K.counters()
    _check_path(K, counts, "fit_amares")
    slice14["fit_launches"] = {n: counts["launches"][n] for n in K.PATHS["fit_amares"]}
    conv_z = float(ds_z["fit_converged"].values.mean())
    got_z = np.stack([ds_z[n].values.reshape(b, -1) for n in fams])
    maps_4c = np.stack([ds[n].values.reshape(b, -1) for n in fams])
    ratio_z = float((np.abs(got_z - maps_4c) / (2e-3 + 0.1 * sd)).max())
    slice14.update(fit_converged=conv_z, fit_max_ratio_to_0_1_crlb=ratio_z,
                   fit_bit_equal_4c=bool(np.array_equal(got_z, maps_4c)))
    print(f"   .xmr.fit_amares in {slice14['fit_amares_s']:.3f} s, launches "
          f"{slice14['fit_launches']}: converged {conv_z:.4f} (limit >= 0.95); "
          f"every voxel within 2e-3 + 0.1 CRLB of 4c's maps: max ratio "
          f"{ratio_z:.3f} (limit 1); bit for bit 4c's: "
          f"{slice14['fit_bit_equal_4c']}", flush=True)
    if conv_z < 0.95 or not ratio_z <= 1.0:
        raise AssertionError(".xmr.fit_amares on the CUDA payload off 4c's maps")
    del got_z, maps_4c

    # 4. The column at the grid's centre: the fit on the card and on the
    # host, the spectra on the card and a CPU copy, one voxel of each.
    ix, iy, iz = bi.GRID[0] // 2, bi.GRID[1] // 2, bi.GRID[2] // 2
    col_host = ds_z.isel(x=ix, y=iy)
    col_card = XmrDataset({k: v.to(dev) for k, v in col_host.items()},
                          col_host.attrs)
    spec_col = spec.isel(x=ix, y=iy)
    fid_v = grid_da.isel(x=ix, y=iy, z=iz).assign_attrs(
        reference_frequency=bi.MHZ, carrier_ppm=0.0)  # the prior's PCr at 0 ppm
    payloads = {  # name: (the card payload, its CPU copy)
        "qc_grid": (col_card, col_host), "trajectory": (col_card, col_host),
        "waterfall": (spec_col.real, spec_col.real.to("cpu")),
        "carpet": (spec_col.real, spec_col.real.to("cpu")),
        "phase_spectrum": (spec_col.isel(z=iz), spec_col.isel(z=iz).to("cpu")),
        "scroll_spectra": (spec_col, spec_col.to("cpu")),
        "apodize": (fid_v, fid_v.to("cpu"))}
    n_z = bi.GRID[2]
    # The independent host computation, from host copies of the same results.
    raw_np, fit_np = col_host["raw_data"].values, col_host["fit_data"].values
    amp_np, crlb_np = col_host["amplitude"].values, col_host["crlb"].values
    col_np = spec_col.values
    f_np = spec.coords["frequency"].values
    fid_np = fid_v.values

    def _spec64(x):
        return np.real(np.fft.fftshift(np.fft.fft(x.astype(np.complex128), axis=-1,
                                                  norm="ortho"), axes=-1))

    raw_S, fit_S = _spec64(raw_np), _spec64(fit_np)
    qc_scale = float(np.abs(raw_S).max())
    dt64 = float(t_np.astype(np.float64)[1] - t_np.astype(np.float64)[0])
    half_np = amp_np * (np.nan_to_num(crlb_np, nan=0.0) / 100.0)
    peak_np = np.max(np.abs(col_np.real))
    mag_np = np.abs(col_np[iz]).astype(float)
    n2 = 1 << max(bi.N_TIME - 1, 1).bit_length()
    want = {
        "qc_grid": {"x": np.fft.fftshift(np.fft.fftfreq(bi.N_TIME, d=dt64)),
                    "raw": raw_S, "fit": fit_S,
                    "red": np.nanmax(np.nan_to_num(crlb_np, nan=np.inf), axis=1)
                    > PlotQCGridConfig().crlb_threshold},
        "trajectory": {"y": amp_np.T, "band": np.stack(
            [np.minimum(amp_np - half_np, amp_np + half_np),
             np.maximum(amp_np - half_np, amp_np + half_np)], -1).transpose(1, 0, 2)},
        "waterfall": {  # normalised and offset as the plot does, row by row
            "y": np.stack([(col_np.real[i] / peak_np) * 10.0 + i * 0.5
                           for i in range(n_z)]),
            "x": f_np[None, :] + (np.arange(n_z) * 0.5)[:, None]
            * np.tan(np.radians(-20.0)),
            "values": col_np.real},
        "carpet": {"mesh": col_np.real, "values": col_np.real},
        "phase_spectrum": {"reals": col_np[iz].real.astype(float),
                           "imags": col_np[iz].imag.astype(float), "mag": mag_np,
                           "pivot_val": float(f_np[int(np.argmax(mag_np))])},
        "scroll_spectra": {"spectra": col_np.real.astype(float)},
        "apodize": {"reals_t": np.pad(fid_np.real, (0, n2 - bi.N_TIME)).astype(float),
                    "imags_t": np.pad(fid_np.imag, (0, n2 - bi.N_TIME)).astype(float)},
    }
    tol = {"qc_grid": {"raw": 1e-5 * qc_scale, "fit": 1e-5 * qc_scale,
                       "x": 1e-9 * float(np.abs(f_np).max())}}

    def _draw(name, payload):
        """What ``name`` draws from ``payload``, as arrays, and the figure or
        widget (None where the extra is missing)."""
        if name == "qc_grid":
            if has_mpl:
                fig = payload.xmr.plot.qc_grid("z", PlotQCGridConfig(max_plots=16))
                axs = [a for a in fig.axes if a.axison]
                fail = to_rgba(PlotQCGridConfig().fail_color)
                return {"x": axs[0].lines[0].get_xdata(),
                        "raw": np.stack([a.lines[0].get_ydata() for a in axs]),
                        "fit": np.stack([a.lines[1].get_ydata() for a in axs]),
                        "red": np.array([a.get_facecolor() == fail for a in axs])}, fig
            p = _host.qc_panels(payload, "z", 16, True)
            return {"x": p.freq, "raw": p.raw.values, "fit": p.fit.values}, None
        if name == "trajectory":
            if has_mpl:
                ax = payload.xmr.plot.trajectory("z")
                bands = []
                for c in ax.collections:
                    v = c.get_paths()[0].vertices
                    bands.append([(v[v[:, 0] == x, 1].min(), v[v[:, 0] == x, 1].max())
                                  for x in range(n_z)])
                return {"y": np.stack([ln.get_ydata() for ln in ax.lines]),
                        "band": np.array(bands)}, ax.get_figure()
            lines = _host.trajectory_lines(payload, "z").lines
            return {"y": np.stack([a for _, a, _ in lines]), "band": np.stack(
                [np.stack([np.minimum(a - h, a + h), np.maximum(a - h, a + h)], -1)
                 for _, a, h in lines])}, None
        if name in ("waterfall", "carpet"):
            if not has_mpl:
                return {"values": _host.stack_view(payload, stack_dim="z").values}, None
            if name == "waterfall":
                ax = payload.xmr.plot.waterfall(stack_dim="z")
                lines = ax.lines[::-1]  # drawn back to front
                return {"x": np.stack([ln.get_xdata() for ln in lines]),
                        "y": np.stack([ln.get_ydata() for ln in lines])}, ax.get_figure()
            ax = payload.xmr.plot.carpet(stack_dim="z")
            mesh = next(c for c in ax.collections if isinstance(c, QuadMesh))
            return {"mesh": np.asarray(mesh.get_array())}, ax.get_figure()
        keys = [k for k in want[name]]
        if has_widgets:
            w = {"phase_spectrum": payload.xmr.widget.phase_spectrum,
                 "scroll_spectra": payload.xmr.widget.scroll_spectra,
                 "apodize": payload.xmr.widget.apodize}[name]()
            return {k: np.asarray(getattr(w, k)) for k in keys}, w
        traits = {"phase_spectrum": _host.phase_traits,
                  "scroll_spectra": _host.scroll_traits,
                  "apodize": _host.apodize_traits}[name](payload)
        return {k: np.asarray(traits[k]) for k in keys}, None

    def _held(what, got, ref, atol):
        if got.shape != ref.shape:
            raise AssertionError(f"{what}: shape {got.shape}, not {ref.shape}")
        err = float(np.abs(got.astype(float) - ref.astype(float)).max()) \
            if got.size else 0.0
        if not (np.array_equal(got, ref) if atol == 0 else err <= atol):
            raise AssertionError(f"{what}: max|err| {err:.3e} over {atol:.3e}")
        return err

    d2h = {"n": 0}
    to_numpy = carrier._to_numpy

    def _counting(x):
        if isinstance(x, torch.Tensor) and x.device == dev:
            d2h["n"] += 1
        return to_numpy(x)

    figures = ("qc_grid", "trajectory", "waterfall", "carpet")
    copy_bound = {"qc_grid": 4, "trajectory": 2}  # else 1
    tmp4z = Path(tempfile.mkdtemp(prefix="xmt_smoke_4z_"))
    slice14.update(d2h_copies={}, max_err={}, png_save_ms={}, html_bytes={})
    carrier._to_numpy = _counting
    try:
        for name, (card, cpu) in payloads.items():
            d2h["n"] = 0
            drawn, obj = _draw(name, card)
            copies = d2h["n"]
            d2h["n"] = 0
            drawn_cpu, obj_cpu = _draw(name, cpu)
            cpu_copies = d2h["n"]
            slice14["d2h_copies"][name] = copies
            bound = copy_bound.get(name, 1)
            if copies > bound or (cpu_copies and dev.type == "cuda"):
                raise AssertionError(f"{name}: {copies} device-to-host copies "
                                     f"(bound {bound}), {cpu_copies} on the CPU copy")
            errs = {}
            for k, got in drawn.items():
                atol = tol.get(name, {}).get(k, 0)
                errs[k] = _held(f"{name} {k} vs numpy", got, np.asarray(want[name][k]),
                                atol)
                _held(f"{name} {k}: card vs the CPU copy", got,
                      np.asarray(drawn_cpu[k]), atol)
            slice14["max_err"][name] = errs
            if obj is None:
                pass
            elif name in figures:
                t0 = time.perf_counter()
                obj.savefig(tmp4z / f"{name}.png")
                slice14["png_save_ms"][name] = 1e3 * (time.perf_counter() - t0)
                plt.close(obj)
                plt.close(obj_cpu)
            else:
                factory = {"phase_spectrum": xwidget.phase_spectrum,
                           "scroll_spectra": xwidget.scroll_spectra,
                           "apodize": xwidget.apodize_interactive}[name]
                if "IPython" in missing:
                    html = xwidget.widget_to_iframe_html(factory(card))
                else:
                    html = xwidget.export_widget_static(factory, card).data
                (tmp4z / f"{name}.html").write_text(html)
                b64 = html.split("base64,", 1)[1].split('"', 1)[0]
                engine = Path(type(obj)._esm).read_text()
                if engine not in base64.b64decode(b64).decode():
                    raise AssertionError(f"{name}: the HTML lacks its JS engine")
                slice14["html_bytes"][name] = len(html)
            print(f"   {name}: {copies} device-to-host copies (bound {bound}); "
                  f"max|err| vs numpy {errs}; the CPU copy draws the same", flush=True)
        slice14["qc_red_panels"] = np.flatnonzero(want["qc_grid"]["red"]).tolist()
        print(f"   qc_grid panels whose worst CRLB is above 20 % or NaN: "
              f"{slice14['qc_red_panels']}" + (" (red, as drawn)" if has_mpl else ""))
        # Each figure and widget on the card payload, 5 rounds in turns.
        turns = {name: [] for name in payloads}
        for rnd in range(5):
            names = list(payloads) if rnd % 2 == 0 else list(payloads)[::-1]
            for name in names:
                _sync()
                t0 = time.perf_counter()
                _, obj = _draw(name, payloads[name][0])
                turns[name].append(1e3 * (time.perf_counter() - t0))
                if obj is not None and name in figures:
                    plt.close(obj)
        slice14["ms_in_turns"] = {k: float(np.median(v)) for k, v in turns.items()}
        for name, xs in turns.items():
            print(f"   in turns, {name}: median {slice14['ms_in_turns'][name]:.3f} "
                  f"ms ({', '.join(f'{x:.3f}' for x in xs)})")
        slice14["files"] = sorted(p.name for p in tmp4z.iterdir())
    finally:
        carrier._to_numpy = to_numpy
        shutil.rmtree(tmp4z, ignore_errors=True)
    if not has_mpl:
        slice14["png_save_ms"] = None
    del spec, spec_col, grid_da, ds_z, col_card, payloads
    torch.cuda.empty_cache()

    # ---- 4za. the planar matmul DFT and PipelineConfig.dft_variant ----
    _phase("4za the planar matmul DFT: dft_planar on the card, then the bench "
           "grid at every dft_variant")
    from xmris_tpu_torch.ops.kernels import dft as mdft
    from xmris_tpu_torch.parallel.planar_pipeline import _spectrum_stage

    @contextlib.contextmanager
    def _tf32_on():
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old[0]
            torch.set_float32_matmul_precision(old[1])

    slice16 = {"card": smi, "dft_planar": {}, "precision": {}, "grid": {}}
    matmul_variants = ("einsum", "flat", "block", "full")
    # 1. dft_planar in float32 on the card against numpy's float64 FFT of
    # the same float32 inputs (5e-6 max|S|, tests/test_planar.py's bar),
    # then bit for bit the same call with TF32 on.
    rng16 = np.random.default_rng(16)
    for n in (13, 100, 2048):
        z = (rng16.normal(size=(256, n)) + 1j * rng16.normal(size=(256, n))
             ).astype(np.complex64)
        xr16, xi16 = (torch.as_tensor(np.ascontiguousarray(a), device=dev)
                      for a in (z.real, z.imag))
        for variant in matmul_variants:
            for inverse in (False, True):
                want = (np.fft.ifft if inverse else np.fft.fft)(
                    z.astype(np.complex128), norm="ortho")
                got = mdft.dft_planar(xr16, xi16, n, inverse=inverse,
                                      variant=variant)
                with _tf32_on():
                    got_tf = mdft.dft_planar(xr16, xi16, n, inverse=inverse,
                                             variant=variant)
                _sync()
                err = float(np.abs(got[0].double().cpu().numpy()
                                   + 1j * got[1].double().cpu().numpy()
                                   - want).max() / np.abs(want).max())
                same = all(_same_bits(a, b) for a, b in zip(got, got_tf))
                key = f"{variant} n={n}{' inverse' if inverse else ''}"
                slice16["dft_planar"][key] = {"err_over_max": err,
                                              "tf32_bit_equal": same}
                if not (err <= 5e-6 and same):
                    raise AssertionError(f"dft_planar {key}: error {err:.3e} of "
                                         f"max|S| (limit 5e-6), TF32 on bit "
                                         f"for bit: {same}")
    worst = max(v["err_over_max"] for v in slice16["dft_planar"].values())
    print(f"   dft_planar float32 on the card, {len(slice16['dft_planar'])} "
          f"calls (4 variants x n 13/100/2048 x forward/inverse, 256 rows): "
          f"worst error {worst:.3e} of max|S| (limit 5e-6); with TF32 on, "
          f"bit for bit every call", flush=True)
    # 2. The emulated TPU precisions at n = 2048 (einsum) and the bench's
    # rectangular fused matrix (1024 -> 2048): "high" within 2^-16 of
    # max|S|, "default" within 1e-2 and measurably worse than "highest".
    z = (rng16.normal(size=(256, 2048)) + 1j * rng16.normal(size=(256, 2048))
         ).astype(np.complex64)
    xr16, xi16 = (torch.as_tensor(np.ascontiguousarray(a), device=dev)
                  for a in (z.real, z.imag))
    for name, fn, want in (
            ("einsum n=2048", lambda p: mdft.dft_planar(
                xr16, xi16, 2048, variant="einsum", precision=p),
             np.fft.fft(z.astype(np.complex128), norm="ortho")),
            ("fused 1024 -> 2048", lambda p: mdft.dft_rect_shifted_planar(
                xr16[:, :1024], xi16[:, :1024], 2048, precision=p),
             np.fft.fftshift(np.fft.fft(z[:, :1024].astype(np.complex128), 2048,
                                        norm="ortho"), axes=-1))):
        errs = {}
        for prec in ("highest", "high", "default"):
            out = fn(prec)
            with _tf32_on():
                out_tf = fn(prec)
            _sync()
            errs[prec] = float(np.abs(out[0].double().cpu().numpy()
                                      + 1j * out[1].double().cpu().numpy()
                                      - want).max() / np.abs(want).max())
            if not all(_same_bits(a, b) for a, b in zip(out, out_tf)):
                raise AssertionError(f"{name} {prec}: TF32 changed the result")
        slice16["precision"][name] = errs
        print(f"   {name}: error of max|S| highest {errs['highest']:.3e}, high "
              f"{errs['high']:.3e} (limit 2^-16 = 1.526e-05), default "
              f"{errs['default']:.3e} (limit 1e-2, and > 10x highest); TF32 "
              f"on bit for bit", flush=True)
        if not (errs["highest"] <= 5e-6 and errs["high"] <= 2.0**-16
                and 10 * errs["highest"] < errs["default"] <= 1e-2):
            raise AssertionError(f"{name}: a precision is off its stated error")
    del xr16, xi16, got, got_tf, out, out_tf
    # 3. The bench grid through process_grid_planar_raw at every variant:
    # K1 exactly for None and "pallas", never for the matmul variants; the
    # spectra turned onto the None run's phases within 5e-6 max|S|; the
    # pivot row's ACME within x1.001 both ways; the fit within 2e-3 + 0.1
    # CRLB (it reads the FIDs).
    cfg16 = PipelineConfig(zero_fill_to=bi.ZERO_FILL, autophase="single",
                           ap_optimizer="grid")
    runs16 = {}
    for variant in (None, "pallas", "fused") + matmul_variants:
        c16 = dataclasses.replace(cfg16, dft_variant=variant)
        K.reset_counters()
        runs16[variant] = process_grid_planar_raw(*args, **dict(fit_kw, cfg=c16))
        _sync()
        counts = K.counters()
        kernel_dft = variant in (None, "pallas")
        _check_path(K, counts, "grid_single_pivot" if kernel_dft
                    else "grid_single_pivot_dft")
        if counts["launches"]["spectrum"] != int(kernel_dft):
            raise AssertionError(f"dft_variant={variant!r}: K1 launched "
                                 f"{counts['launches']['spectrum']} times")
        slice16["grid"][str(variant)] = {"k1_launches": counts["launches"]["spectrum"]}
    # The stage at None is the parent's: one K1 call, bit for bit.
    stage = _spectrum_stage(re, im, w_d, cfg16, True, K.DISPATCH)
    direct = dft_cuda.spectrum(re, im, bi.ZERO_FILL, window=win, with_maxmag=True)
    _sync()
    if not all(torch.equal(a, b) for a, b in zip(stage, direct)):
        raise AssertionError("dft_variant=None: the stage is not K1's call")
    un_re, un_im = direct[0], direct[1]
    v_piv = int(torch.argmax(direct[2]))
    row16 = (un_re[v_piv:v_piv + 1].double(), un_im[v_piv:v_piv + 1].double())
    f64 = f_d.double()
    sr0, si0, (a0, a1, apiv), x0, _, _, sds0 = runs16[None]

    def _ramp(q0, q1, qpiv):
        return (torch.deg2rad(q0.double()) + torch.deg2rad(q1.double())
                * ((f64 - qpiv.double()) / (f64[-1] - f64[0])))

    def _acme16(q0, q1, qpiv):
        return float(_acme_scores(acme_score_raw, _phased_real_planar, *row16,
                                  f64, q0.double()[None], q1.double()[None],
                                  qpiv.double()[None], float(f64[-1] - f64[0]))[0])

    s_none = _acme16(a0, a1, apiv)
    sc16 = float(torch.maximum(sr0.abs().max(), si0.abs().max()))
    for variant, out16 in runs16.items():
        sr_v, si_v, (q0, q1, qpiv), x_v = out16[:4]
        d = (_ramp(a0, a1, apiv) - _ramp(q0, q1, qpiv)).float()[None]
        c, s_ = torch.cos(d), torch.sin(d)
        rec = slice16["grid"][str(variant)]
        rec["spectra_err"] = max(
            _assert_close(f"dft_variant={variant!r} spectra re (turned onto "
                          "None's phases)", sr0, sr_v * c - si_v * s_, 0.0,
                          5e-6 * sc16),
            _assert_close(f"dft_variant={variant!r} spectra im",
                          si0, sr_v * s_ + si_v * c, 0.0, 5e-6 * sc16))
        ratio = _acme16(q0, q1, qpiv) / s_none
        rec.update(p0=float(q0), p1=float(q1), pivot=float(qpiv),
                   acme_ratio=ratio, bit_equal_none=bool(
                       torch.equal(sr_v, sr0) and torch.equal(si_v, si0)))
        print(f"   dft_variant={variant!r}: K1 {rec['k1_launches']}, phases "
              f"({float(q0):.5f}, {float(q1):.5f}) at pivot {float(qpiv):.4f}; "
              f"ACME of the pivot row / None's {ratio:.7f} (limit x1.001 both "
              f"ways); spectra bit for bit None's: {rec['bit_equal_none']}",
              flush=True)
        if not 1 / 1.001 <= ratio <= 1.001:
            raise AssertionError(f"dft_variant={variant!r}: ACME off None's")
        _within_crlb(f"dft_variant={variant!r} x_free vs None's", x_v, x0, sds0)
    if not slice16["grid"]["pallas"]["bit_equal_none"]:
        raise AssertionError("dft_variant='pallas' differs from None")
    del runs16, stage, direct, un_re, un_im, sr0, si0
    # 4. The stacked layout needs the kernel.
    stk = spectral_pipeline_planar_raw(re, im, w_d, f_d, dataclasses.replace(
        cfg16, dft_variant="pallas", spec_layout="stacked"))
    if stk[0].dim() != 3:
        raise AssertionError("stacked pallas spectra are not (B, n2, n1)")
    try:
        spectral_pipeline_planar_raw(re, im, w_d, f_d, dataclasses.replace(
            cfg16, dft_variant="einsum", spec_layout="stacked"))
    except ValueError as e:
        print(f"   stacked + 'pallas': {tuple(stk[0].shape)}; stacked + "
              f"'einsum' raises ValueError: {e}")
    else:
        raise AssertionError("stacked + einsum did not raise")
    del stk
    # 5. mrsi_pipeline at dft_variant="fused" on the labeled grid, then
    # .xmr.fit_amares: no K1; spectra within 5e-6 max|S| of 4s's turned
    # onto this run's phases; the maps within 2e-3 + 0.1 CRLB of 4c's.
    cfg_f = dataclasses.replace(mrsi_cfgs["grid search"], dft_variant="fused")
    out_f = _mrsi_run(K, mrsi_pipeline, da, cfg_f, "mrsi_pipeline_dft", 0)
    ref_f = torch.as_tensor(mrsi_out["grid search"].values, device=dev)
    f_m64t = torch.as_tensor(f_m64, device=dev)

    def _factor16(o):
        return phase_factor_raw(f_m64t, float(o.attrs["phase_p0"]),
                                float(o.attrs["phase_p1"]),
                                float(o.attrs["phase_pivot"]),
                                float(f_m64t.max() - f_m64t.min()))

    got_f = torch.as_tensor(out_f.values, device=dev)
    turned = ref_f * (_factor16(out_f) / _factor16(mrsi_out["grid search"])
                      ).to(ref_f.dtype)
    s_f = float(ref_f.abs().max())
    slice16["mrsi_fused_err"] = max(
        _assert_close("mrsi_pipeline fused vs 4s's turned re", got_f.real,
                      turned.real, 0.0, 5e-6 * s_f),
        _assert_close("mrsi_pipeline fused vs 4s's turned im", got_f.imag,
                      turned.imag, 0.0, 5e-6 * s_f))
    K.reset_counters()
    ds_f = da.xmr.fit_amares(pk)
    _sync()
    _check_path(K, K.counters(), "fit_amares")
    got_m = np.stack([ds_f[n].values.reshape(b, -1) for n in fams])
    maps_4c = np.stack([ds[n].values.reshape(b, -1) for n in fams])
    slice16["fit_max_ratio_to_0_1_crlb"] = float(
        (np.abs(got_m - maps_4c) / (2e-3 + 0.1 * sd)).max())
    print(f"   .xmr.fit_amares after it: max |dx| / (2e-3 + 0.1 CRLB) vs 4c's "
          f"{slice16['fit_max_ratio_to_0_1_crlb']:.3f} (limit 1)", flush=True)
    if not slice16["fit_max_ratio_to_0_1_crlb"] <= 1.0:
        raise AssertionError("the fit after the fused mrsi_pipeline is off 4c's")
    del out_f, ref_f, got_f, turned, ds_f, got_m, maps_4c
    # 6. Each variant's spectral stage (autophase "none") against K1's, one
    # call a turn timed by CUDA events, 7 rounds, the order reversed every
    # other round; the peak memory of one call.
    cfg_t = dataclasses.replace(cfg16, autophase="none")
    turns16 = {str(v): [] for v in (None, "fused") + matmul_variants}
    peak16 = {}
    for v in turns16:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        spectral_pipeline_planar_raw(re, im, w_d, f_d, dataclasses.replace(
            cfg_t, dft_variant=None if v == "None" else v))
        _sync()
        peak16[v] = (torch.cuda.max_memory_allocated() - base) / 2**30
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for rnd in range(7):
        order = list(turns16) if rnd % 2 == 0 else list(turns16)[::-1]
        for v in order:
            c_v = dataclasses.replace(cfg_t, dft_variant=None if v == "None" else v)
            _sync()
            ev0.record()
            spectral_pipeline_planar_raw(re, im, w_d, f_d, c_v)
            ev1.record()
            _sync()
            turns16[v].append(ev0.elapsed_time(ev1))
    slice16["stage_ms_in_turns"] = {v: float(np.median(x)) for v, x in turns16.items()}
    slice16["stage_peak_gib"] = peak16
    # The least time of each stage: its planes read and spectra written
    # once over the memory rate, or its contractions' operations (K1's
    # FFT: 5 n log2 n a voxel) over the rate of their type, float64 on
    # the tensor cores for the matmul DFT (data sheet, like the fp32 rate).
    n_in, n_f = bi.N_TIME, bi.ZERO_FILL
    n1, n2 = mdft.plan_dft(n_f)[1:3]
    flops16 = {"None": 5 * n_f * np.log2(n_f) * b,
               "fused": 2 * b * (2 * n_in) * (2 * n_f),
               "full": 2 * b * (2 * n_f) ** 2,
               **{v: 8 * b * n_f * (n1 + n2) for v in ("einsum", "flat", "block")}}
    bytes16 = 4 * b * 2 * (n_in + n_f)
    slice16["stage_bound_ms"] = {}
    for v, x in turns16.items():
        t_ops = 1e3 * flops16[v] / (PEAK_FP32_FLOPS if v == "None"
                                    else PEAK_FP64_TENSOR_FLOPS)
        bound = max((1e3 * bytes16 / PEAK_BYTES_PER_S, "bytes"),
                    (t_ops, "operations"))
        slice16["stage_bound_ms"][v] = bound
        print(f"   spectral stage (autophase 'none'), dft_variant={v}: median "
              f"{slice16['stage_ms_in_turns'][v]:.4f} ms "
              f"({', '.join(f'{t:.4f}' for t in x)}); bound {bound[0]:.4f} ms "
              f"({bound[1]}); peak {peak16[v]:.3f} GiB above the inputs",
              flush=True)
    torch.cuda.empty_cache()

    # ---- 5. timing ----
    _phase("5 timing")
    times = []
    for _ in range(5):
        _sync()
        t0 = time.perf_counter()
        process_grid_planar_raw(*args, **fit_kw)
        _sync()
        times.append(time.perf_counter() - t0)
    ms = 1e3 * float(np.median(times))
    print(f"   grid times ms: {[round(1e3 * x, 3) for x in times]}")
    print(f"   median {ms:.3f} ms/grid = {b / (ms / 1e3):.1f} voxels/s "
          f"({b} voxels)")
    # The grid and its fit stage at each kernel_version in turns, 10 rounds
    # with the order reversed every other round, so that the versions share
    # the state of the card and of the host: medians with their quartiles,
    # and the rounds in which each version beat v9.
    fit_only = {k: v for k, v in fit_kw.items() if k != "cfg"}
    versions = (9, 10, 3, 5, 8, 6, 7, 2, 1)
    turns = {(what, v): [] for what in ("grid", "fit") for v in versions}
    for rnd in range(10):
        for v in (versions if rnd % 2 == 0 else versions[::-1]):
            for what, fn in (
                ("grid", lambda: process_grid_planar_raw(
                    *args, **fit_kw, kernel_version=v)),
                ("fit", lambda: seeded_fit_grid_raw(
                    re, im, t_d, xt_d, lower, upper, kind, **fit_only,
                    kernel_version=v)),
            ):
                _sync()
                t0 = time.perf_counter()
                fn()
                _sync()
                turns[(what, v)].append(1e3 * (time.perf_counter() - t0))
    grid_ms = {}
    for (what, v), xs in turns.items():
        q1, med, q3 = np.percentile(xs, [25, 50, 75])
        wins = sum(a < c for a, c in zip(xs, turns[(what, 9)]))
        label = "grid" if what == "grid" else "seeded fit + CRLB"
        print(f"   in turns, kernel_version={v} {label}: median {med:.3f} ms "
              f"(quartiles {q1:.3f}-{q3:.3f})"
              + ("" if v == 9 else f", faster than v9 in {wins}/10 rounds"))
        if what == "grid":
            grid_ms[v] = float(med)
    for v in versions[1:]:
        print(f"   kernel_version={v}: {grid_ms[v]:.3f} ms/grid = "
              f"{b / (grid_ms[v] / 1e3):.1f} voxels/s")
    stages = {
        "spectral stage": lambda: spectral_pipeline_planar_raw(
            re, im, w_d, f_d, cfg),
        "seeding": lambda: seed_grid(
            re, im, t_d, xt_d, lower, upper, kind, pmap_static=ps,
            mhz=bi.MHZ, amp_slots=amp_slots, ls_plan=ls_plan),
        "seeded fit + CRLB": lambda: seeded_fit_grid_raw(
            re, im, t_d, xt_d, lower, upper, kind, **fit_only),
        "per-voxel spectral stage": lambda: spectral_pipeline_planar_raw(
            re, im, w_d, f_d, cfg_all),
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
    times_all = []
    for _ in range(5):
        _sync()
        t0 = time.perf_counter()
        process_grid_planar_raw(*args, **fit_kw_all)
        _sync()
        times_all.append(time.perf_counter() - t0)
    ms_all = 1e3 * float(np.median(times_all))
    print(f"   per-voxel autophase grid times ms: "
          f"{[round(1e3 * x, 3) for x in times_all]}; median {ms_all:.3f} "
          f"ms/grid = {b / (ms_all / 1e3):.1f} voxels/s")
    fit_times = []
    for _ in range(3):
        _sync()
        t0 = time.perf_counter()
        fit_amares(da, pk, return_curves=True)
        _sync()
        fit_times.append(time.perf_counter() - t0)
    fit_med = float(np.median(fit_times))
    print(f"   fit_amares times s: {[round(x, 3) for x in fit_times]}; "
          f"median {fit_med:.3f} s = {b / fit_med:.1f} voxels/s")
    fit_times = []
    for _ in range(3):
        _sync()
        t0 = time.perf_counter()
        fit_amares(da, pk, return_curves=True, kernel_version=10)
        _sync()
        fit_times.append(time.perf_counter() - t0)
    fit_med10 = float(np.median(fit_times))
    print(f"   fit_amares(kernel_version=10) times s: "
          f"{[round(x, 3) for x in fit_times]}; median {fit_med10:.3f} s = "
          f"{b / fit_med10:.1f} voxels/s")
    fit_times = []
    for _ in range(3):
        _sync()
        t0 = time.perf_counter()
        fit_amares(da, pk, return_curves=True, kernel_version=8)
        _sync()
        fit_times.append(time.perf_counter() - t0)
    fit_med8 = float(np.median(fit_times))
    print(f"   fit_amares(kernel_version=8) times s: "
          f"{[round(x, 3) for x in fit_times]}; median {fit_med8:.3f} s = "
          f"{b / fit_med8:.1f} voxels/s")
    # This slice's entry points, in turns: 5 rounds, the order reversed
    # every other round; ms per call, median.
    rows64 = sr_m.double()
    slice_calls = {
        "mrsi_pipeline grid search": lambda: mrsi_pipeline(
            da, cfg=mrsi_cfgs["grid search"]),
        "mrsi_pipeline DE default": lambda: mrsi_pipeline(da, cfg=cfg_m),
        "mrsi_pipeline per voxel": lambda: mrsi_pipeline(da, cfg=cfg_mv),
        **{f"per-voxel grid search, {pol} polish": (
            lambda pol=pol: spectral_pipeline_planar_raw(
                re, im, w_d, f_d, dataclasses.replace(cfg_all, ap_polish=pol)))
           for pol in ("auto", "gd", "newton", "bfgs")},
        "AsLS grid, CR float64": lambda: als_baseline_batched(rows64, **asls),
        "scipy autophase, pivot row": lambda: autophase(row_da,
                                                         optimizer="scipy"),
    }
    slice_turns = {k: [] for k in slice_calls}
    for rnd in range(5):
        names = list(slice_calls) if rnd % 2 == 0 else list(slice_calls)[::-1]
        for name in names:
            _sync()
            t0 = time.perf_counter()
            slice_calls[name]()
            _sync()
            slice_turns[name].append(1e3 * (time.perf_counter() - t0))
    slice_ms = {k: float(np.median(v)) for k, v in slice_turns.items()}
    for name, xs in slice_turns.items():
        print(f"   in turns, {name}: median {slice_ms[name]:.3f} ms "
              f"({', '.join(f'{x:.1f}' for x in xs)})")
    if profile_dir:
        _profile(process_grid_planar_raw, args, fit_kw, ms, profile_dir,
                 "single-pivot grid", "profile.txt")
        _profile(process_grid_planar_raw, args, fit_kw_all, ms_all,
                 profile_dir, "per-voxel grid", "profile_per_voxel.txt")
        for v in (10, 3, 8, 7):
            _profile(process_grid_planar_raw, args,
                     dict(fit_kw, kernel_version=v), grid_ms[v], profile_dir,
                     f"kernel_version={v} grid", f"profile_v{v}.txt")
        _profile(seeded_fit_grid_raw, g_args, g_fit, g_ms["free-g grid"],
                 profile_dir, "free-g grid fit", "profile_free_g.txt")
        _profile(process_grid_planar_raw, args, de_kw, de_ms["DE pivot grid"],
                 profile_dir, "DE pivot grid", "profile_de_pivot.txt")
        _profile(mrsi_pipeline, (da,), dict(cfg=mrsi_cfgs["grid search"]),
                 slice_ms["mrsi_pipeline grid search"], profile_dir,
                 "mrsi_pipeline, grid search", "profile_mrsi.txt")
        _profile(spectral_pipeline_planar_raw, (re, im, w_d, f_d),
                 dict(cfg=dataclasses.replace(cfg_all, ap_polish="newton")),
                 slice_ms["per-voxel grid search, newton polish"],
                 profile_dir, "per-voxel grid search, newton polish",
                 "profile_newton.txt")
        _profile(als_baseline_batched, (rows64,), asls,
                 slice_ms["AsLS grid, CR float64"], profile_dir,
                 "AsLS grid, CR float64", "profile_asls.txt")
    del rows64, sr_m
    torch.cuda.empty_cache()

    replaces = {
        "spectrum": ("xmris_tpu_torch/ops/kernels/csrc/spectrum.cu",
                     "xmris_tpu/ops/kernels/dft_pallas.py:324"),
        "eq6_normal_eq_v9": ("xmris_tpu_torch/ops/kernels/csrc/lm_v9.cu",
                             "xmris_tpu/ops/kernels/lm_pallas.py:1937"),
        "spd_solve_damped": ("xmris_tpu_torch/ops/kernels/csrc/spd.cu",
                             "xmris_tpu/ops/kernels/spd.py:312"),
        "spd_inverse_diag": ("xmris_tpu_torch/ops/kernels/csrc/spd.cu",
                             "xmris_tpu/ops/kernels/spd.py:377"),
        "acme_polish": ("xmris_tpu_torch/ops/kernels/csrc/acme.cu",
                        "xmris_tpu/ops/kernels/acme_pallas.py:193"),
        "spd_inverse_diag_dense": ("xmris_tpu_torch/ops/kernels/csrc/spd.cu",
                                   "xmris_tpu/ops/kernels/spd.py:421"),
        "spd_solve_damped_dense": ("xmris_tpu_torch/ops/kernels/csrc/spd.cu",
                                   "xmris_tpu/ops/kernels/spd.py:254"),
        "eq6_normal_eq_v3": ("xmris_tpu_torch/ops/kernels/csrc/lm_jac.cu",
                             "xmris_tpu/ops/kernels/lm_pallas.py:442"),
        "eq6_normal_eq_v5": ("xmris_tpu_torch/ops/kernels/csrc/lm_jac.cu",
                             "xmris_tpu/ops/kernels/lm_pallas.py:631"),
        "lm_loop_v10": ("xmris_tpu_torch/ops/kernels/csrc/lm_v10.cu",
                        "xmris_tpu/ops/kernels/lm_pallas.py:2382"),
        "eq6_normal_eq_v8": ("xmris_tpu_torch/ops/kernels/csrc/lm_v8.cu",
                             "xmris_tpu/ops/kernels/lm_pallas.py:1366"),
        "eq6_normal_eq_v7": ("xmris_tpu_torch/ops/kernels/csrc/lm_jac.cu",
                             "xmris_tpu/ops/kernels/lm_pallas.py:1093"),
        "eq6_normal_eq_v6": ("xmris_tpu_torch/ops/kernels/csrc/lm_jac.cu",
                             "xmris_tpu/ops/kernels/lm_pallas.py:843"),
        "eq6_normal_eq_v2": ("xmris_tpu_torch/ops/kernels/csrc/lm_jac.cu",
                             "xmris_tpu/ops/kernels/lm_pallas.py:1493"),
        "eq6_normal_eq_v1": ("xmris_tpu_torch/ops/kernels/csrc/lm_jac.cu",
                             "xmris_tpu/ops/kernels/lm_pallas.py:175"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": replaces[name][0],
         "replaces": replaces[name][1], "launches": launches[name],
         "max_abs_err": report[name]["err"], "ms": report[name]["ms"],
         "plain_ms": report[name]["plain_ms"],
         "bound_ms": report[name]["bound"][0],
         "bound_by": report[name]["bound"][1],
         "library_ms": report[name]["library_ms"]}
        for name in replaces
    ]
    print(json.dumps({"ms_per_grid": ms, "voxels_per_s": b / (ms / 1e3),
                      **{f"ms_per_grid_v{v}": grid_ms[v] for v in versions},
                      "ms_per_grid_per_voxel_autophase": ms_all,
                      "fit_amares_s": fit_med, "fit_amares_v10_s": fit_med10,
                      "fit_amares_v8_s": fit_med8, "voxels": b}))
    print(json.dumps({"free_g": {
        "kernels": {k: {"ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                        "max_abs_err": r["err"]}
                    for k, r in free_g_report.items()},
        "launches": {k: {n: c for n, c in v.items() if c}
                     for k, v in free_g_launches.items()},
        "ms_in_turns": g_ms, "grid_converged": conv_g, "grid_pcr_err": pcr_g,
        "grid_lm_done": done_g, "grid_share_x_vs_plain": share_x,
        "grid_cost_vs_plain": cost_g, "grid_cost_control": ctl_g,
        "voigt_grid": voigt,
        "fit_amares_s": fit_g_med, "fit_amares_converged": conv_fg,
        "fit_amares_pcr_err": pcr_fg, "fit_amares_share_vs_plain": share_fg,
        "fit_amares_cost_vs_plain": cost_fg,
        "fit_amares_cost_control": ctl_fg},
        "de": {"pivot_ms_in_turns": de_ms, "pivot_p0_p1": [float(p0d), float(p1d)],
               "pivot_acme": s_de, "grid_p0_p1": [float(p0), float(p1)],
               "grid_acme": s_grid, "per_voxel_grid_s": pv_de_s,
               "per_voxel_chunk": chunk,
               "per_voxel_search_s_by_chunk": chunk_s}}))
    print(json.dumps({"slice_11": {
        "ms_in_turns": slice_ms, "roi_s": roi, "scipy_s": scipy_s,
        "asls_first_s": asls_first_s, "asls_peak_gib": peak_gb,
        "asls_cr_vs_scan": err, "asls_limit": lim}}))
    print(json.dumps({"slice_12": slice12}))
    print(json.dumps({"slice_13": slice13}))
    print(json.dumps({"slice_14": slice14}))
    print(json.dumps({"slice_16": slice16}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _check_path(K, counts, path):
    """Every kernel of ``path`` launched, no plain version ran, and no other
    kernel launched."""
    for name in K.LAUNCHES:
        n = counts["launches"][name]
        if name in K.PATHS[path] and n <= 0:
            raise AssertionError(f"{path}: kernel {name} was not launched")
        if name not in K.PATHS[path] and n != 0:
            raise AssertionError(f"{path}: kernel {name} launched {n} times")
        if counts["plain_calls"][name] != 0:
            raise AssertionError(f"{path}: plain {name} ran on the main path")
    print(f"   {path}: launched {[n for n in K.PATHS[path]]}, 0 plain calls")


def _mrsi_run(K, mrsi_pipeline, da, cfg, path, n):
    """One ``mrsi_pipeline`` call on the card with the counters set to 0
    just before it: every kernel of ``path`` launched exactly ``n`` times,
    no other kernel and no plain version."""
    K.reset_counters()
    out = mrsi_pipeline(da, cfg=cfg)
    _sync()
    counts = K.counters()
    _check_path(K, counts, path)
    for name in K.PATHS[path]:
        if counts["launches"][name] != n:
            raise AssertionError(f"{path}: {name} launched "
                                 f"{counts['launches'][name]} times, not {n}")
    return out


def _same_as_raw(name, out, raw, b, n_out):
    """The front-end's spectra and phases equal the raw pipeline's bit for
    bit."""
    import numpy as np
    import torch

    sr, si, phases = raw
    spec = out.values.reshape(b, n_out)
    same = (np.array_equal(spec.real, sr.reshape(b, n_out).cpu().numpy())
            and np.array_equal(spec.imag, si.reshape(b, n_out).cpu().numpy()))
    for key, v in zip(("phase_p0", "phase_p1", "phase_pivot"), phases):
        same = same and np.array_equal(
            np.ravel(out.attrs[key]).astype(np.float32),
            np.ravel(v.cpu().numpy()))
    print(f"   {name}: spectra and phases bit for bit the raw pipeline's on "
          f"the same planes, window and frequencies: {same}")
    if not same:
        raise AssertionError(f"{name}: differs from spectral_pipeline_planar_raw")


def _scores_both_ways(name, a, b):
    """Every finite score within x1.02 + 1e-9 of the other's, both ways
    (tests/test_acme_pallas.py:163), and the same +inf voxels."""
    import torch

    fin = torch.isfinite(b)
    if not torch.equal(fin, torch.isfinite(a)):
        raise AssertionError(f"{name}: the +inf voxels differ")
    a, b = a[fin].double(), b[fin].double()
    worst = max(float((a / (b * 1.02 + 1e-9)).max()),
                float((b / (a * 1.02 + 1e-9)).max()))
    print(f"   {name}: max score ratio / limit {worst:.5f} (x1.02 + 1e-9 both "
          f"ways, {int(fin.sum())} voxels)", flush=True)
    if worst > 1.0:
        raise AssertionError(f"{name}: a score is above the other's x1.02")


def _within_crlb(name, x, x_ref, sds, limit=1.0):
    """Every entry within 2e-3 + 0.1 CRLB of the reference (tensors or
    arrays of one shape); with ``limit=None`` only reported."""
    worst = float(((x - x_ref).abs() / (2e-3 + 0.1 * sds)).max())
    print(f"   {name}: max |dx| / (2e-3 + 0.1*CRLB) = {worst:.3f} "
          + ("(reported)" if limit is None else f"(limit {limit:g})"))
    if limit is not None and not worst <= limit:
        raise AssertionError(f"{name} differs by more than 0.1 CRLB")


def _rotated_close(name, sr, si, sr_p, si_p, dphi):
    """Spectra within 1e-6 max|S| after rotating the plain path's onto the
    kernel path's phases."""
    import torch

    c, s = torch.cos(dphi), torch.sin(dphi)
    rot_re, rot_im = sr_p * c - si_p * s, sr_p * s + si_p * c
    sc = float(torch.maximum(sr_p.abs().max(), si_p.abs().max()))
    _assert_close(f"{name} re", sr, rot_re, 0.0, 1e-6 * sc)
    _assert_close(f"{name} im", si, rot_im, 0.0, 1e-6 * sc)


def _acme_scores(score_fn, phased_fn, sr, si, f, p0, p1, piv, x_range,
                 chunk=2048):
    """ACME score of every voxel's row at its phases (chunked rows)."""
    import torch

    out = []
    for i in range(0, sr.shape[0], chunk):
        sl = slice(i, i + chunk)
        out.append(score_fn(phased_fn(sr[sl], si[sl], f, p0[sl], p1[sl],
                                      piv[sl][:, None], x_range)))
    return torch.cat(out)


def _profile(fn, args, kw, grid_ms, out_dir, label, filename):
    """One grid under torch.profiler: device busy time as a share of the
    unprofiled median grid time ``grid_ms``, and kernel tables by device
    and by host time to ``out_dir/filename``."""
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
    out.mkdir(parents=True, exist_ok=True)
    (out / filename).write_text(by_dev + "\n\n" + by_cpu)
    print(f"   profile, {label}: {kernels} device kernels, device busy "
          f"{busy_us / 1e3:.3f} ms = {100 * busy_us / 1e3 / grid_ms:.1f} % "
          f"of the unprofiled median {grid_ms:.3f} ms/grid")
    print("\n".join(by_dev.splitlines()[:16]))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
