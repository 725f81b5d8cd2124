"""Plain reference of the spectral stage: window, zero-fill, ortho DFT,
fftshift, and the single-pivot ACME phase.

Written from the method's definitions (the upstream xmris chain
``zero_fill -> apodize_exp -> to_spectrum -> autophase``; ACME: Chen et al.,
J. Magn. Reson. 158 (2002) 164), in plain PyTorch, at a dtype given by the
caller: float64 for the comparison, bfloat16 for the control.  Nothing of
the program is imported or read here but the outputs that are judged.
"""

from __future__ import annotations

import math

import torch

DEG = math.pi / 180.0


def window(config: dict, dtype=torch.float64, device="cpu"):
    """exp(-pi lb t) over the acquired points."""
    t = torch.arange(config["n_time"], dtype=torch.float64, device=device)
    return torch.exp(-math.pi * config["lb_hz"] * t / config["sw_hz"]).to(dtype)


def freqs(config: dict, device="cpu"):
    """The centred frequency axis (zero_fill,) in Hz, float64."""
    n, sw = config["zero_fill"], config["sw_hz"]
    k = torch.arange(n, dtype=torch.float64, device=device) - n // 2
    return k * (sw / n)


def _dft_matrix(n_in: int, n_out: int, dtype, device):
    """The zero-filled, ortho-normalized, fftshifted DFT as (n_in, n_out)
    real and imaginary planes: column j is output bin j - n_out/2."""
    j = torch.arange(n_in, dtype=torch.float64, device=device)[:, None]
    k = (torch.arange(n_out, dtype=torch.float64, device=device) - n_out // 2)[None, :]
    ang = -2.0 * math.pi * torch.remainder(j * k, n_out) / n_out
    s = 1.0 / math.sqrt(n_out)
    return (torch.cos(ang) * s).to(dtype), (torch.sin(ang) * s).to(dtype)


def spectra(re, im, config: dict, dtype=torch.float64):
    """Unphased spectra (B, zero_fill) as ``(s_re, s_im)`` in ``dtype``,
    from (B, n_time) FID planes.  float64 takes the FFT; a lower precision
    takes the DFT as matmuls in that precision (``torch.fft`` has no
    bfloat16)."""
    n_out = config["zero_fill"]
    w = window(config, dtype, re.device)
    xr, xi = re.to(dtype) * w, im.to(dtype) * w
    if dtype == torch.float64:
        z = torch.fft.fft(torch.complex(xr, xi), n=n_out, norm="ortho")
        z = torch.fft.fftshift(z, dim=-1)
        return z.real, z.imag
    c, s = _dft_matrix(xr.shape[-1], n_out, dtype, re.device)
    return xr @ c - xi @ s, xr @ s + xi @ c


def pivot(s_re, s_im):
    """(voxel, bin) of the largest |S|^2 over the grid: the first maximum."""
    mag = (s_re.double() ** 2 + s_im.double() ** 2)
    per_voxel, bins = mag.max(dim=1)
    v = int(torch.argmax(per_voxel))
    return v, int(bins[v])


def phase_angle(f, p0, p1, piv):
    """The phase ramp (radians) p0 + p1 (f - pivot) / range, degrees in."""
    x_range = f[-1] - f[0]
    return p0 * DEG + p1 * DEG * ((f - piv) / x_range)


def rotate(s_re, s_im, phi):
    c, s = torch.cos(phi), torch.sin(phi)
    return s_re * c - s_im * s, s_re * s + s_im * c


def acme(real):
    """ACME objective over the last axis: the entropy of |first difference|
    plus 1000 x the squared negative area, over the length and the maximum;
    +inf where the maximum is not positive."""
    ds1 = ((real[..., 1:] - real[..., :-1]) / 2.0).abs()
    p = ds1 / ds1.sum(-1, keepdim=True)
    p = torch.where(p == 0, torch.ones_like(p), p)
    h = -(p * torch.log(p)).sum(-1)
    neg = real - real.abs()
    sneg = neg.sum(-1)
    pfun = torch.where(sneg < 0, ((neg / 2.0) ** 2).sum(-1), torch.zeros_like(sneg))
    top = real.amax(-1)
    score = (h + 1000.0 * pfun) / real.shape[-1] / top
    return torch.where(top > 0, score, torch.full_like(score, math.inf))


def score_at(row_re, row_im, f, piv, p0, p1, dtype=torch.float64):
    """ACME of a row turned by each (p0, p1) of equal-shaped tensors."""
    phi = phase_angle(f.to(dtype), p0.to(dtype)[..., None], p1.to(dtype)[..., None],
                      piv)
    real = row_re.to(dtype) * torch.cos(phi) - row_im.to(dtype) * torch.sin(phi)
    return acme(real)


def best_phase(row_re, row_im, f, piv, p1_span=4000.0, coarse=(181, 201),
               keep=8, levels=14, dtype=torch.float64, chunk=4096):
    """The (p0, p1) in [-180, 180) x [-p1_span, p1_span] degrees of least
    ACME on one row: a coarse grid, then each of the ``keep`` best coarse
    points refined by ``levels`` zooms of a 9 x 9 grid (the step shrinks
    threefold a level).  Returns ``(p0, p1, score)`` as floats."""
    dev = row_re.device
    p0s = torch.linspace(-180.0, 180.0, coarse[0], dtype=torch.float64, device=dev)
    p1s = torch.linspace(-p1_span, p1_span, coarse[1], dtype=torch.float64, device=dev)
    g0, g1 = torch.meshgrid(p0s, p1s, indexing="ij")
    g0, g1 = g0.reshape(-1), g1.reshape(-1)

    def scores(a, b):
        return torch.cat([score_at(row_re, row_im, f, piv, a[i:i + chunk],
                                   b[i:i + chunk], dtype).double()
                          for i in range(0, a.numel(), chunk)])

    sc = scores(g0, g1)
    order = torch.argsort(sc)[:keep]
    step0, step1 = float(p0s[1] - p0s[0]), float(p1s[1] - p1s[0])
    off = torch.linspace(-1.0, 1.0, 9, dtype=torch.float64, device=dev)
    o0, o1 = torch.meshgrid(off, off, indexing="ij")
    o0, o1 = o0.reshape(-1), o1.reshape(-1)
    best = (0.0, 0.0, math.inf)
    for i in order.tolist():
        c0, c1, s0, s1 = float(g0[i]), float(g1[i]), step0, step1
        cur = float(sc[i])
        for _ in range(levels):
            a, b = c0 + s0 * o0, c1 + s1 * o1
            s = scores(a, b)
            j = int(torch.argmin(s))
            if float(s[j]) <= cur:
                c0, c1, cur = float(a[j]), float(b[j]), float(s[j])
            s0, s1 = s0 / 3.0, s1 / 3.0
        if cur < best[2]:
            best = (c0, c1, cur)
    p0 = (best[0] + 180.0) % 360.0 - 180.0
    return p0, best[1], best[2]
