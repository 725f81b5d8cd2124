"""AMARES Eq.6 time-domain forward model (PyTorch port).

Port of :mod:`xmris_tpu.models.lineshapes`.  The model (Vanhamme et al.,
J Magn Reson 1997, 129(1):35-43, Eq. 6) covers the Lorentzian (g=0),
Gaussian (g=1) and Voigt-like (0<g<1) lineshapes:

    y(t) = sum_k  a_k * exp(j*phi_k) * exp(-d_k * (1 - g_k + g_k*t) * t)
                * exp(j*2*pi*f_k*t)

Plain functions on tensors: they run on their inputs' device and dtype
(float64 in, complex128 out), and autograd differentiates them.
"""

from __future__ import annotations

import math

import torch


def eq6_fid(t, amplitudes, frequencies, dampings, phases, lineshape_g):
    """Complex FID for one voxel.

    ``t``: (n_time,) seconds (any dead-time offset included);
    ``amplitudes, frequencies, dampings, phases, lineshape_g``: (n_peaks,)
    a_k, f_k [Hz], d_k [1/s], phi_k [rad], g_k in [0, 1].  Returns the
    (n_time,) complex tensor.
    """
    t_col = t[:, None]
    decay = torch.exp(-dampings * (1.0 - lineshape_g + lineshape_g * t_col) * t_col)
    angle = 2.0 * math.pi * frequencies * t_col + phases
    osc = torch.complex(torch.cos(angle), torch.sin(angle))
    return torch.sum(amplitudes * decay * osc, dim=1)


def eq6_fid_multi(t, amplitudes, frequencies, dampings, phases, lineshape_g):
    """Batched Eq.6: every per-peak argument has shape (batch, n_peaks);
    returns (batch, n_time)."""
    t_col = t[None, :, None]  # (1, n_time, 1)
    a = amplitudes[:, None, :]
    f = frequencies[:, None, :]
    d = dampings[:, None, :]
    p = phases[:, None, :]
    g = lineshape_g[:, None, :]
    decay = torch.exp(-d * (1.0 - g + g * t_col) * t_col)
    angle = 2.0 * math.pi * f * t_col + p
    osc = torch.complex(torch.cos(angle), torch.sin(angle))
    return torch.sum(a * decay * osc, dim=2)
