#!/usr/bin/env python3
"""Shards on one card: run in turn on the calling thread (as
``parallel.mesh.run_on_devices`` runs the shards of one device) against a
host thread per shard.

Usage, on a machine with a CUDA card and nvcc, from the root of a checkout:

    python3 scripts/ablate_mesh_threads.py [--rounds N] [--shards S]

On the bench grid (32x32x16 voxels, 1024 -> 2048 points, the 5-peak 31P
prior) it times, in N rounds (default 10) with the order reversed every
other round, the single-pivot grid program (``process_grid_sharded``,
grid search, stacked spectra) and ``fit_amares(return_curves=False)``:
unsharded, and over ``Mesh([cuda:0] * S)`` (default S = 4) with the
shards run as ``run_on_devices`` runs them (in turn) and with
``parallel.mesh.THREAD_PER_SHARD`` set, which gives each shard a host
thread of its own under ``torch.cuda.device`` (the same per-shard work,
through the same runner).  Each result is held bit
for bit against the shipped runner's.  Prints the card's name and power
limit and the median ms of each (host clock around a synchronized call).
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv) -> int:
    import numpy as np
    import torch

    from xmris_tpu_torch import bench_inputs as bi
    from xmris_tpu_torch.core.array import Coord, XmrArray
    from xmris_tpu_torch.fitting.amares import fit_amares, seed_plan, template_optimum
    from xmris_tpu_torch.fitting.lm import hashable_pmap
    from xmris_tpu_torch.fitting.prior import prior_from_csv_text
    from xmris_tpu_torch.ops.kernels import _build
    from xmris_tpu_torch.parallel import mesh as mesh_mod
    from xmris_tpu_torch.parallel import process as process_mod
    from xmris_tpu_torch.parallel.mesh import Mesh
    from xmris_tpu_torch.parallel.pipeline import PipelineConfig

    if not torch.cuda.is_available():
        print("ablate_mesh_threads: needs a CUDA device", file=sys.stderr)
        return 2
    rounds = int(argv[argv.index("--rounds") + 1]) if "--rounds" in argv else 10
    n_sh = int(argv[argv.index("--shards") + 1]) if "--shards" in argv else 4
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    _build.library()
    fids, weight, freqs = bi.make_inputs()
    pk = prior_from_csv_text(bi.PK_CSV, "bench PK_CSV")
    t_np = (np.arange(bi.N_TIME) / bi.SW).astype(np.float32)
    x_t = template_optimum(fids, pk, torch.from_numpy(t_np).to(dev), bi.MHZ)
    args = process_mod.grid_inputs_from_numpy(fids, weight, freqs, t_np, x_t, pk,
                                              dev)
    amp_slots, ls_plan = seed_plan(pk)
    kw = dict(cfg=PipelineConfig(zero_fill_to=bi.ZERO_FILL, ap_optimizer="grid",
                                 spec_layout="stacked"),
              pmap_static=hashable_pmap(pk.pmap), mhz=bi.MHZ,
              amp_slots=amp_slots, ls_plan=ls_plan, max_iter=24,
              uniform_t_ok=True)
    da = XmrArray(fids.reshape(bi.GRID + (bi.N_TIME,)), dims=("x", "y", "z", "time"),
                  coords={"time": Coord("time", t_np.astype(np.float64))},
                  attrs={"MHz": bi.MHZ})
    mesh = Mesh([dev] * n_sh)

    def runner(which):
        mesh_mod.THREAD_PER_SHARD = which == "thread per shard"

    def grid(which):
        if which == "unsharded":
            return process_mod.process_grid_planar_raw(*args, **kw)
        runner(which)
        return process_mod.process_grid_sharded(*args, mesh=mesh, **kw)

    def fit(which):
        if which == "unsharded":
            return fit_amares(da, pk, return_curves=False)
        runner(which)
        return fit_amares(da, pk, return_curves=False, mesh=mesh)

    def flat(out):
        if isinstance(out, torch.Tensor):
            return [out]
        if isinstance(out, (tuple, list)):
            return [x for o in out for x in flat(o)]
        return [torch.as_tensor(out[n].values) for n in
                ("amplitude", "chem_shift", "linewidth", "phase", "crlb")]

    for name, fn in (("grid", grid), ("fit_amares", fit)):
        ref = flat(fn("in turn"))
        if not all(torch.equal(a, b) for a, b in
                   zip(flat(fn("thread per shard")), ref)):
            raise AssertionError(f"{name}: a thread per shard differs")
    kinds = ("unsharded", "in turn", "thread per shard")
    for name, fn, reps in (("grid", grid, 3), ("fit_amares", fit, 1)):
        times = {k: [] for k in kinds}
        for rnd in range(rounds):
            for k in (kinds if rnd % 2 == 0 else kinds[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn(k)
                torch.cuda.synchronize()
                times[k].append(1e3 * (time.perf_counter() - t0) / reps)
        for k in kinds:
            q1, med, q3 = np.percentile(times[k], [25, 50, 75])
            label = k if k == "unsharded" else f"{n_sh} shards on cuda:0, {k}"
            print(f"{name}, {label}: median {med:.3f} ms (quartiles "
                  f"{q1:.3f}-{q3:.3f}, {rounds} rounds)", flush=True)
    runner("in turn")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
