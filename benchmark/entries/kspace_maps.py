"""Multi-coil k-space to fitted maps through the public labeled API, the
chain of ``serve``'s lean fit: ``recon.kspace.kspace_to_image``,
``recon.sense.sense_combine`` with the known maps,
``parallel.pipeline.mrsi_pipeline`` on the card payload, then
``.xmr.fit_amares(prior, return_curves=False)``.  A request ends when the
fitted maps are on the host; the combined FIDs and the spectra stay on the
card."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.traffic import generator

MAPS = ("amplitude", "chem_shift", "linewidth", "phase")


def setup(ctx):
    from xmris_tpu_torch.core.array import Coord, XmrArray
    from xmris_tpu_torch.fitting.prior import prior_from_csv_text
    from xmris_tpu_torch.parallel import pipeline
    from xmris_tpu_torch.recon import kspace, sense

    cfg, dev = ctx.config, ctx.device
    pk = prior_from_csv_text(cfg["prior_csv"], cfg["name"])
    t = generator.time_axis(cfg)
    maps = torch.as_tensor(ctx.pool[0]["maps"].astype(np.complex64), device=dev)
    sens = XmrArray(maps[..., None].expand(maps.shape + (cfg["n_time"],)),
                    dims=("coil", "x", "y", "z", "time"))
    pipe_cfg = pipeline.PipelineConfig(**ctx.mix["pipeline"])
    # On the CPU (a rehearsal) the fit runs the kernel engine's plain twins,
    # the path the card takes, rather than the CPU's pure-tensor default.
    on_cpu = torch.device(dev).type == "cpu"
    where = {"device": "cpu"} if on_cpu else {}
    fit_kw = dict(ctx.mix["fit"], kernels=ctx.kernels, **where,
                  **({"engine": "pallas"} if on_cpu else {}))

    def run(ksp):
        da = XmrArray(ksp, dims=("coil", "kx", "ky", "kz", "time"),
                      coords={"time": Coord("time", t)}, attrs={"MHz": cfg["mhz"]})
        img = kspace.kspace_to_image(da)
        rec = sense.sense_combine(img, sens)
        spec = pipeline.mrsi_pipeline(rec, cfg=pipe_cfg, kernels=ctx.kernels,
                                      **where)
        ds = rec.xmr.fit_amares(pk, **fit_kw)
        return rec, spec, ds

    return run


def request(run, grid):
    rec, spec, ds = run(grid["kspace"])
    maps = {n: np.asarray(ds[n].values) for n in MAPS + ("crlb", "fit_converged")}
    phases = tuple(float(spec.attrs[k]) for k in ("phase_p0", "phase_p1", "phase_pivot"))
    return {"recon": rec.data, "spectra": spec.data, "phases": phases, "maps": maps}


def failed(out):
    spec = out["spectra"]
    finite = bool(torch.isfinite(torch.view_as_real(spec)).all())
    return not (finite and np.isfinite(out["phases"]).all()
                and all(np.isfinite(v).all() for v in out["maps"].values()))


def record(grid, out):
    m = out["maps"]
    k = m["amplitude"].shape[-1]
    x = np.stack([m[n].reshape(-1, k) for n in MAPS], axis=-1)
    spec = out["spectra"].reshape(x.shape[0], -1)
    rec = out["recon"].reshape(x.shape[0], -1)
    return {"inputs": {"kspace": grid["kspace"], "maps": grid["maps"]},
            "recon": (rec.real, rec.imag), "spectra": (spec.real, spec.imag),
            "phases": out["phases"],
            "fit": {"x": x, "converged": m["fit_converged"].reshape(-1),
                    "crlb_pct": m["crlb"].reshape(-1, k)}}
