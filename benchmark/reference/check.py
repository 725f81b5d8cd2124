"""The comparison that decides ``correct``: the program's outputs of sampled
requests against the plain reference, number by number.

A request's outputs come in one form whatever the entry (see
``entries/__init__.py``): the pool grid it read, and whichever of
``recon``, ``spectra``/``phases`` and ``fit`` it produced.  The reference
works from the generated inputs alone (the FID planes, or the k-space and
the coil maps) and reads the program's outputs only to judge them:

* ``recon_err``: the combined FIDs, max |program - reference| over
  max |reference|;
* ``acme_gap``: ACME of the program's phased spectrum at the reference's
  pivot voxel (its real part as delivered), over the least ACME that the
  reference's own search finds on its float64 row, minus 1.  The
  single-pivot search sits in a flat p0-p1 valley, where data one rounding
  away settles elsewhere; so the phases are judged by the score the
  delivered spectrum reaches, not by their values;
* ``spec_err``: the program's spectra against the reference's turned by
  the program's phases, max |difference| over max |S|;
* ``fit_excess``: over a seeded sample of voxels, the float64 cost at the
  program's parameters summed, over the reference fit's summed, minus 1
  (a voxel the program leaves without parameters counts at them);
* ``unconverged``: the share of the sample the program does not report
  converged;
* ``cost_gap``: the program's reported cost against the float64 cost at
  its own parameters, the widest relative gap in the sample;
* ``crlb_gap``: the program's CRLB standard deviations (or CRLB % of the
  amplitudes) against the reference's at the program's parameters, the
  widest relative gap over the sampled voxels that have parameters.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import fit as rfit
from benchmark.reference import recon as rrecon
from benchmark.reference import spectra as rspec


def _rel_max(got_re, got_im, ref_re, ref_im):
    scale = torch.sqrt(ref_re ** 2 + ref_im ** 2).max()
    err = torch.sqrt((got_re.double() - ref_re) ** 2
                     + (got_im.double() - ref_im) ** 2).max()
    return float(err / scale)


def _fids(rec, config):
    """The reference's (B, n) float64 FID planes of the request's grid, and
    ``recon_err`` where the program recon'd them."""
    inp = rec["inputs"]
    n = config["n_time"]
    if "kspace" not in inp:
        return inp["re"].double(), inp["im"].double(), {}
    y_re, y_im = rrecon.recon(inp["kspace"], inp["maps"])
    y_re, y_im = y_re.reshape(-1, n), y_im.reshape(-1, n)
    out = {}
    if "recon" in rec:
        g_re, g_im = (x.reshape(-1, n) for x in rec["recon"])
        out["recon_err"] = _rel_max(g_re, g_im, y_re, y_im)
    return y_re, y_im, out


def _judge_spectra(rec, config, y_re, y_im, params):
    s_re, s_im = rspec.spectra(y_re, y_im, config)
    f = rspec.freqs(config, s_re.device)
    v, k = rspec.pivot(s_re, s_im)
    p0, p1, piv = (float(x) for x in rec["phases"])
    out = {}
    _, _, best = rspec.best_phase(s_re[v], s_im[v], f, f[k],
                                  coarse=tuple(params["phase_grid"]))
    g_re, g_im = (x.reshape(s_re.shape) for x in rec["spectra"])
    got = float(rspec.acme(g_re[v].double()))
    out["acme_gap"] = (got - best) / abs(best)
    phi = rspec.phase_angle(f, p0, p1, piv)
    r_re, r_im = rspec.rotate(s_re, s_im, phi)
    out["spec_err"] = _rel_max(g_re, g_im, r_re, r_im)
    return out


def _judge_fit(rec, config, y_re, y_im, params, prior, rng):
    fit = rec["fit"]
    b = y_re.shape[0]
    idx = np.sort(rng.choice(b, size=min(int(params["sample_voxels"]), b),
                             replace=False))
    dev = y_re.device
    it = torch.as_tensor(idx, device=dev)
    yr, yi = y_re[it], y_im[it]
    t = torch.arange(config["n_time"], dtype=torch.float64, device=dev) / config["sw_hz"]
    mhz = config["mhz"]
    x_ref, c_ref, _ = rfit.lm_fit(yr, yi, t, mhz, prior, iters=int(params["fit_iters"]))
    x_p = torch.as_tensor(np.asarray(fit["x"], np.float64)[idx], device=dev)
    c_at = rfit.cost(x_p, yr, yi, t, mhz)
    conv = torch.as_tensor(np.asarray(fit["converged"], bool)[idx], device=dev)
    out = {"unconverged": float(1.0 - conv.double().mean()),
           "fit_excess": float(c_at.sum() / c_ref.sum() - 1.0)}
    if fit.get("cost") is not None:
        c_p = torch.as_tensor(np.asarray(fit["cost"], np.float64)[idx], device=dev)
        out["cost_gap"] = float(((c_p - c_at).abs() / c_at).max())
    sd_ref = rfit.crlb(x_p, yr, yi, t, mhz)
    has = (x_p[..., 0] != 0).all(-1) & torch.isfinite(x_p).all(-1).all(-1)
    if fit.get("sds") is not None:
        sd_p = torch.as_tensor(np.asarray(fit["sds"], np.float64)[idx], device=dev)
        gap = ((sd_p - sd_ref).abs() / sd_ref)[has]
    else:
        ref_pct = 100.0 * sd_ref[:, 0::4] / x_p[..., 0].abs()
        pct = torch.as_tensor(np.asarray(fit["crlb_pct"], np.float64)[idx], device=dev)
        gap = ((pct - ref_pct).abs() / ref_pct)[has]
    gap = torch.where(torch.isnan(gap), torch.full_like(gap, math.inf), gap)
    out["crlb_gap"] = float(gap.max()) if gap.numel() else math.inf
    return out


def judge(rec, config, params, seed: int, sample: int):
    """The numbers of one sampled request (see the module's docstring).
    ``seed`` and ``sample`` seed the draw of the voxels whose fit is
    compared."""
    with torch.no_grad():
        y_re, y_im, out = _fids(rec, config)
        if "spectra" in rec:
            out.update(_judge_spectra(rec, config, y_re, y_im, params))
        if "fit" in rec:
            prior = rfit.parse_prior(config["prior_csv"])
            rng = np.random.default_rng([int(seed), int(sample), 7])
            out.update(_judge_fit(rec, config, y_re, y_im, params, prior, rng))
    return out


def merge(per_sample):
    """The worst of each number over the sampled requests."""
    names = sorted({k for d in per_sample for k in d})
    return {k: max(d[k] for d in per_sample if k in d) for k in names}
