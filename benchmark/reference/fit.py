"""Plain reference of the prior-knowledge AMARES fit: the Lorentzian model,
a bounded Levenberg-Marquardt fit from a linear least-squares start, and
the Cramér-Rao bounds.

Written from the model's definition (Vanhamme et al., J. Magn. Reson. 129
(1997) 35, Eq. 6 with g = 0): each peak k is
``a_k exp(i ph_k) exp((-pi lw_k + 2 pi i cs_k MHz) t)``, and the cost is
the sum of |y - model|^2 over the acquired points.  Parameters are the
prior's free ones, peak after peak: amplitude, shift (ppm), linewidth (Hz),
phase (degrees).  Plain PyTorch at a dtype given by the caller: float64
for the comparison, bfloat16 for the control (its linear solves, which
torch has no bfloat16 for, in float32).
"""

from __future__ import annotations

import csv
import io
import math

import torch

DEG = math.pi / 180.0
COLS = ("amplitude", "chemicalshift", "linewidth", "phase")
JUDGES = "the reference judges untied Lorentzian priors (Eq. 6 with g = 0)"
SECTIONS = ("Initial Values", "Bounds")


def _refuse(name, key, cell, what):
    raise ValueError(f"prior column {name!r}, row {key!r}, cell {cell!r}: {what}; "
                     f"{JUDGES}")


def _number(name, key, cell):
    try:
        return float(cell)
    except ValueError:
        _refuse(name, key, cell, "a tie to another line's parameter" if "*" in cell
                else "not a number")


def _bounds(name, key, cell):
    """``(lo, hi)`` of a bound cell, infinite where a side is empty."""
    lo, _, hi = cell.strip("()").partition(",")
    return (_number(name, key, lo.strip()) if lo.strip() else -math.inf,
            _number(name, key, hi.strip()) if hi.strip() else math.inf)


def parse_prior(text: str):
    """The prior CSV (the upstream pyAMARES layout): ``(init, lower, upper)``
    as (K, 4) float64 tensors, columns amplitude, shift, linewidth, phase.
    Below the header, ``Initial Values`` and its rows of numbers, then
    ``Bounds`` and its rows of cells ``"(lo, hi)"``, ``"(lo, "`` with no
    upper bound; a row per parameter, the four above and g.

    Raises ``ValueError``, naming the column and the cell, for what the
    model above cannot judge: a tie (``factor*Metab``), a parameter of the
    four pinned by ``fixed`` or by equal bounds, and a g that is not fixed
    at 0 (a g left out of ``Bounds`` is free upstream); and, naming the
    row, for any other row (``Expressions``, ``LessConstraints``)."""
    rows = [r for r in csv.reader(io.StringIO(text)) if r]
    names = [c.strip() for c in rows[0][1:] if c.strip()]
    k = len(names)
    init = torch.zeros((k, 4), dtype=torch.float64)
    lower = torch.full((k, 4), -math.inf, dtype=torch.float64)
    upper = torch.full((k, 4), math.inf, dtype=torch.float64)
    g_init, g_bound = ["0"] * k, [""] * k
    in_bounds = False
    for row in rows[1:]:
        key = row[0].strip()
        cells = [c.strip() for c in row[1:k + 1]] + [""] * (k + 1 - len(row))
        if key in SECTIONS:
            in_bounds = key == "Bounds"
        elif key == "g" and in_bounds:
            g_bound = cells
        elif key == "g":
            g_init = [c or "0" for c in cells]
        elif key not in COLS:
            raise ValueError(f"prior row {key!r}: not a row the reference reads; {JUDGES}")
        elif not in_bounds:
            init[:, COLS.index(key)] = torch.tensor(
                [_number(n, key, c) for n, c in zip(names, cells)], dtype=torch.float64)
        else:
            c = COLS.index(key)
            for p, cell in enumerate(cells):
                if cell.lower() == "fixed":
                    _refuse(names[p], key, cell, "a fixed parameter")
                lower[p, c], upper[p, c] = _bounds(names[p], key, cell)
                if lower[p, c] == upper[p, c]:
                    _refuse(names[p], key, cell, "a parameter pinned by equal bounds")
    for name, cell, bound in zip(names, g_init, g_bound):
        if bound.lower() == "fixed":
            value = _number(name, "g", cell)
        else:
            lo, hi = _bounds(name, "g", bound)
            value, cell = (lo if lo == hi else math.nan), bound
        if value != 0.0:
            _refuse(name, "g", cell, "a g that is not fixed at 0")
    return init, lower, upper


def basis(x, t, mhz: float):
    """Each peak's complex signal a_k e^{i ph} e^{(-pi lw + 2 pi i cs MHz) t}
    as planes (B, n, K); ``x`` (B, K, 4)."""
    a, cs, lw, ph = (x[..., None, :, c] for c in range(4))
    tt = t[:, None]
    env = a * torch.exp(-math.pi * lw * tt)
    ang = 2.0 * math.pi * mhz * cs * tt + ph * DEG
    return env * torch.cos(ang), env * torch.sin(ang)


def cost(x, y_re, y_im, t, mhz: float):
    """sum |y - model|^2 per voxel."""
    b_re, b_im = basis(x, t, mhz)
    r_re = y_re - b_re.sum(-1)
    r_im = y_im - b_im.sum(-1)
    return (r_re * r_re + r_im * r_im).sum(-1)


def _jacobian(x, t, mhz: float):
    """d model / d (a, cs, lw, ph) per peak: planes (B, n, K*4), peak-major,
    and the model planes."""
    b_re, b_im = basis(x, t, mhz)
    a = x[..., None, :, 0]
    safe = torch.where(a == 0, torch.ones_like(a), a)
    tt = t[:, None]
    w_cs = 2.0 * math.pi * mhz * tt
    w_lw = -math.pi * tt
    j_re = torch.stack([b_re / safe, -w_cs * b_im, w_lw * b_re, -DEG * b_im], -1)
    j_im = torch.stack([b_im / safe, w_cs * b_re, w_lw * b_im, DEG * b_re], -1)
    sh = j_re.shape
    return (j_re.reshape(sh[:-2] + (sh[-2] * 4,)),
            j_im.reshape(sh[:-2] + (sh[-2] * 4,)), b_re.sum(-1), b_im.sum(-1))


def _solve(h, g):
    """(H) d = g for SPD H, in float32 where ``h`` is of lower precision."""
    dt = h.dtype if h.dtype in (torch.float32, torch.float64) else torch.float32
    return torch.linalg.solve(h.to(dt), g.to(dt)[..., None])[..., 0].to(h.dtype)


def _clip(x, lower, upper):
    ph = torch.remainder(x[..., 3] + 180.0, 360.0) - 180.0
    x = torch.cat([x[..., :3], ph[..., None]], -1)
    lo = torch.where(torch.isfinite(lower), lower, torch.full_like(lower, -1e30))
    hi = torch.where(torch.isfinite(upper), upper, torch.full_like(upper, 1e30))
    m = 1e-6 * torch.where(torch.isfinite(upper - lower), upper - lower,
                           torch.ones_like(lower))
    return torch.minimum(torch.maximum(x, lo + m), hi - m)


def ls_start(y_re, y_im, t, mhz: float, init):
    """Amplitudes and phases by linear least squares at the prior's initial
    shifts and linewidths, in float64: (B, K, 4)."""
    b = y_re.shape[0]
    x = init[None].expand(b, -1, -1).clone().to(torch.float64)
    x[..., 0], x[..., 3] = 1.0, 0.0
    e_re, e_im = basis(x[:1], t.double(), mhz)
    e = torch.complex(e_re[0], e_im[0])  # (n, K), shared by every voxel
    y = torch.complex(y_re.double(), y_im.double())
    c = torch.linalg.solve(e.conj().T @ e, e.conj().T @ y.T).T  # (B, K)
    x[..., 0] = c.abs()
    x[..., 3] = torch.angle(c) / DEG
    return x


def _normal(x, y_re, y_im, t, mhz):
    """Gauss-Newton H (B, F, F), gradient g = J^T r (B, F) and cost."""
    j_re, j_im, m_re, m_im = _jacobian(x, t, mhz)
    r_re, r_im = y_re - m_re, y_im - m_im
    h = j_re.transpose(1, 2) @ j_re + j_im.transpose(1, 2) @ j_im
    g = (j_re * r_re[..., None]).sum(1) + (j_im * r_im[..., None]).sum(1)
    return h, g, (r_re * r_re + r_im * r_im).sum(-1)


def lm_fit(y_re, y_im, t, mhz: float, prior, iters: int = 200,
           dtype=torch.float64, conv_tol: float = 1e-6):
    """Fit every row of the (B, n) planes: ``(x (B, K, 4), cost (B,),
    converged (B,))``, computed in ``dtype``.  A voxel has converged when,
    at its final point and in ``dtype``, the Gauss-Newton step predicts a
    relative decrease of the cost ``g^T H^-1 g / cost`` below
    ``conv_tol``."""
    init, lower, upper = (p.to(y_re.device) for p in prior)
    x = _clip(ls_start(y_re, y_im, t, mhz, init), lower, upper).to(dtype)
    lower, upper = lower.to(dtype), upper.to(dtype)
    y_re, y_im, t = y_re.to(dtype), y_im.to(dtype), t.to(dtype)
    b, k = x.shape[0], x.shape[1]
    lam = torch.full((b,), 1e-3, dtype=torch.float64, device=x.device)
    stop = torch.zeros((b,), dtype=torch.bool, device=x.device)
    h, g, c = _normal(x, y_re, y_im, t, mhz)
    for _ in range(iters):
        d = torch.diagonal(h, dim1=1, dim2=2)
        step = _solve(h + torch.diag_embed(lam.to(dtype)[:, None] * d), g)
        x_t = _clip(x + step.reshape(b, k, 4), lower, upper)
        h_t, g_t, c_t = _normal(x_t, y_re, y_im, t, mhz)
        ok = torch.isfinite(c_t) & (c_t < c) & ~stop
        drop = ((c - c_t) / c).double()
        stop = stop | (ok & (drop < 1e-15)) | (~ok & (lam > 1e10))
        x = torch.where(ok[:, None, None], x_t, x)
        c = torch.where(ok, c_t, c)
        h = torch.where(ok[:, None, None], h_t, h)
        g = torch.where(ok[:, None], g_t, g)
        lam = torch.where(ok, lam * 0.3, lam * 3.0).clamp(1e-15, 1e15)
        if bool(stop.all()):
            break
    pred = (g * _solve(h, g)).sum(-1).double() / c.double()
    conv = torch.isfinite(c) & (pred.abs() < conv_tol)
    return x, c, conv


def crlb(x, y_re, y_im, t, mhz: float, dtype=torch.float64):
    """Standard deviations (B, K*4) of the free parameters at ``x``:
    sigma^2 (J^T J)^-1 with sigma^2 = cost / (2 n - F) per real channel."""
    x, y_re, y_im, t = (v.to(dtype) for v in (x, y_re, y_im, t))
    j_re, j_im, m_re, m_im = _jacobian(x, t, mhz)
    r2 = ((y_re - m_re) ** 2 + (y_im - m_im) ** 2).sum(-1)
    f = j_re.shape[-1]
    sigma2 = r2 / max(2.0 * t.shape[0] - f, 1.0)
    h = j_re.transpose(1, 2) @ j_re + j_im.transpose(1, 2) @ j_im
    dt = h.dtype if h.dtype in (torch.float32, torch.float64) else torch.float32
    inv = torch.linalg.inv(h.to(dt)).to(h.dtype)
    var = sigma2[:, None] * torch.diagonal(inv, dim1=1, dim2=2)
    return torch.sqrt(var.clamp(min=0.0))
