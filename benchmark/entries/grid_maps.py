"""The fused grid program from FID planes to fitted maps:
``xmris_tpu_torch.parallel.process.process_grid_planar_raw`` (spectral
stage, single-pivot phase, LS seed, LM, CRLB).  A request ends when
x_free, cost, converged and the CRLB SDs are on the host; the spectra stay
complete on the card."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.traffic import generator


def setup(ctx):
    from xmris_tpu_torch.fitting.amares import seed_plan, template_optimum
    from xmris_tpu_torch.fitting.lm import hashable_pmap
    from xmris_tpu_torch.fitting.prior import prior_from_csv_text
    from xmris_tpu_torch.parallel import process
    from xmris_tpu_torch.parallel.pipeline import PipelineConfig

    cfg, dev = ctx.config, ctx.device
    pk = prior_from_csv_text(cfg["prior_csv"], cfg["name"])
    amp_slots, ls_plan = seed_plan(pk)
    weight, freqs = generator.spectral_constants(cfg)
    t = generator.time_axis(cfg).astype(np.float32)
    # The template is the protocol's, fitted once on a calibration grid
    # that does not depend on the run's seed (the bench grid, as bench.py
    # fits it), so that every seed's requests start from the same template.
    cal_re, cal_im = generator.fid_grid(cfg, int(ctx.mix["template_seed"]), dev)
    cal = torch.complex(cal_re, cal_im).cpu().numpy()
    del cal_re, cal_im
    x_template = template_optimum(cal, pk, torch.as_tensor(t, device=dev),
                                  cfg["mhz"])

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    const = (f32(weight), f32(freqs), f32(t), f32(x_template), f32(pk.lower),
             f32(pk.upper), torch.as_tensor(np.asarray(pk.kind, np.int32), device=dev))
    kw = dict(cfg=PipelineConfig(**ctx.mix["pipeline"]),
              pmap_static=hashable_pmap(pk.pmap), mhz=cfg["mhz"],
              amp_slots=amp_slots, ls_plan=ls_plan, kernels=ctx.kernels,
              **ctx.mix["fit"])

    def run(re, im):
        w, f, t_d, xt, lo, hi, kind = const
        return process.process_grid_planar_raw(re, im, w, f, t_d, xt, lo, hi,
                                               kind, **kw)

    return run


def request(run, grid):
    s_re, s_im, phases, x_free, cost, conv, sds = run(grid["re"], grid["im"])
    host = [v.cpu().numpy() for v in (x_free, cost, conv, sds)]
    phases = tuple(float(p) for p in phases)
    if s_re.is_cuda:
        torch.cuda.synchronize(s_re.device)
    return {"spectra": (s_re, s_im), "phases": phases, "x_free": host[0],
            "cost": host[1], "converged": host[2], "sds": host[3]}


def failed(out):
    s_re, s_im = out["spectra"]
    finite = bool(torch.isfinite(s_re).all() & torch.isfinite(s_im).all())
    return not (finite and np.isfinite(out["phases"]).all()
                and np.isfinite(out["x_free"]).all()
                and np.isfinite(out["cost"]).all())


def record(grid, out):
    b, f = out["x_free"].shape
    return {"inputs": {"re": grid["re"], "im": grid["im"]},
            "spectra": out["spectra"], "phases": out["phases"],
            "fit": {"x": out["x_free"].reshape(b, f // 4, 4),
                    "cost": out["cost"], "converged": out["converged"],
                    "sds": out["sds"]}}
