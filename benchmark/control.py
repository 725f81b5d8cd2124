"""Readings that set the limits of ``correct``: the program's numbers over
many seeds, and the control's.

    python3 benchmark/control.py --workload <cell> --mode program --seeds 1 2 3 [--seconds 3]
    python3 benchmark/control.py --workload <cell> --mode control --seeds 1 2 3

``program`` runs the cell as a run does (set-up, a closed loop of
``--seconds`` at the cell's load, the same sampled requests) for each seed
in one process, and prints the comparison's numbers.  ``control`` puts the
plain reference in the program's place, computed in bfloat16 (the
precision below the configuration's float32; its linear solves, which
torch has no bfloat16 for, in float32), on the first pooled grids, and
judges it the same way: every limit lies between the two readings.  The
benchmark's own runs never run the control.  One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.reference import check  # noqa: E402
from benchmark.reference import fit as rfit  # noqa: E402
from benchmark.reference import recon as rrecon  # noqa: E402
from benchmark.reference import spectra as rspec  # noqa: E402
from benchmark.traffic import generator  # noqa: E402

LOW = torch.bfloat16


def control_record(cell, grid, dtype=LOW):
    """The reference in the program's place at ``dtype``: the outputs the
    cell's entry would give, in the comparison's form."""
    config = cell.config
    n = config["n_time"]
    entry = cell.workload["entry"]
    rec = {}
    if "kspace" in grid:
        y_re, y_im = rrecon.recon(grid["kspace"], grid["maps"], dtype)
        y_re, y_im = y_re.reshape(-1, n), y_im.reshape(-1, n)
        rec["inputs"] = {"kspace": grid["kspace"], "maps": grid["maps"]}
        rec["recon"] = (y_re, y_im)
    else:
        y_re, y_im = grid["re"].to(dtype), grid["im"].to(dtype)
        rec["inputs"] = {"re": grid["re"], "im": grid["im"]}
    s_re, s_im = rspec.spectra(y_re, y_im, config, dtype)
    f = rspec.freqs(config, s_re.device)
    v, k = rspec.pivot(s_re, s_im)
    p0, p1, _ = rspec.best_phase(s_re[v], s_im[v], f, f[k], dtype=dtype)
    piv = float(f[k])
    phi = rspec.phase_angle(f.to(dtype), p0, p1, piv)
    rec["spectra"] = rspec.rotate(s_re, s_im, phi)
    rec["phases"] = (p0, p1, piv)
    if "fit_excess" not in cell.workload["check"]["limits"]:
        return rec  # a cell that asks for spectra and phases only
    t = torch.arange(n, dtype=torch.float64, device=y_re.device) / config["sw_hz"]
    prior = rfit.parse_prior(config["prior_csv"])
    x, c, conv = rfit.lm_fit(y_re, y_im, t, config["mhz"], prior, dtype=dtype)
    sds = rfit.crlb(x, y_re, y_im, t, config["mhz"], dtype=dtype).double()
    x = x.double().cpu().numpy()
    fit = {"x": x, "converged": conv.cpu().numpy()}
    if entry == "grid_maps":
        fit.update(cost=c.double().cpu().numpy(), sds=sds.cpu().numpy())
    else:
        fit["crlb_pct"] = (100.0 * sds[:, 0::4].cpu().numpy() / np.abs(x[..., 0]))
    rec["fit"] = fit
    return rec


def program_readings(cell, seed, seconds, device="cuda", kernels=None):
    """The program's numbers for ``seed``: set-up, a short closed loop at
    the cell's load, the run's sampled requests judged."""
    from xmris_tpu_torch.ops import kernels as K

    pool = generator.make_pool(cell.config, cell.mix, seed, device)
    entry = harness.entry_module(cell)
    state = entry.setup(harness.context(cell, device, kernels or K.DISPATCH, pool))
    entry.request(state, pool[0])
    sampler = harness.Sampler(seed, cell.workload["check"]["sample_requests"],
                              seconds, entry)
    loop = harness.closed_loop(entry, state, pool, seconds, 1,
                               int(np.prod(cell.config["grid"])), sampler,
                               lambda: torch.cuda.synchronize()
                               if torch.device(device).type == "cuda" else None)
    records = sampler.records()
    del state
    nums = check.merge([check.judge(harness.on_inputs_device(r), cell.config,
                                    cell.workload["check"], seed, j)
                        for j, r in enumerate(records)])
    return {"requests": loop.attempted, "failed": loop.failed, **nums}


def control_readings(cell, seed, device="cuda", dtype=LOW):
    pool = generator.make_pool(cell.config, cell.mix, seed, device)
    params = cell.workload["check"]
    recs = [control_record(cell, pool[j % len(pool)], dtype)
            for j in range(int(params["sample_requests"]))]
    return check.merge([check.judge(r, cell.config, params, seed, j)
                        for j, r in enumerate(recs)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=("program", "control"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        nums = (program_readings(cell, seed, args.seconds) if args.mode == "program"
                else control_readings(cell, seed))
        print(json.dumps({"workload": cell.name, "mode": args.mode, "seed": seed,
                          "seconds": time.perf_counter() - t0, **nums}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
