"""Shared inputs of the PyTorch-port parity tests (``test_torch_*.py``).

Both packages get identical numpy state: the same seeded phantoms, priors
parsed by the JAX package and handed to the port through
``prior_from_numpy``, and the same float32 planes.
"""

from __future__ import annotations

import numpy as np

from test_fitting import PK_CSV as TEST_PK_CSV

from xmris_tpu_torch.bench_inputs import FIXED_AMPS_31P, PEAKS_31P
from xmris_tpu_torch.bench_inputs import PK_CSV as BENCH_PK_CSV

# test_fitting's two-peak prior with g fixed at 0: the grid fit's VARPRO
# override (free g) is not ported, so the fit parity runs on fixed-g priors.
TEST_PK_CSV_FIXED_G = TEST_PK_CSV.replace('g,"(0, 1)","(0, 1)"', "g,fixed,fixed")

N_VOX = 24
N_T = 256
SW = 5000.0
MHZ = 120.0


def load_priors(csv_text, tmp_path, name="pk.csv"):
    """``(reference prior, port prior)`` parsed from the same CSV text."""
    from xmris_tpu.fitting.prior import load_prior_knowledge

    from xmris_tpu_torch.fitting.prior import prior_from_numpy

    p = tmp_path / name
    p.write_text(csv_text)
    pk = load_prior_knowledge(p)
    return pk, prior_from_numpy(pk)


def bench_phantom(n_voxels=N_VOX, n_t=N_T, sw=SW, mhz=MHZ, seed=0):
    """The bench's 5-peak 31P phantom at a small size: complex64 FIDs
    (n_voxels, n_t), float32 t, and the true PCr amplitudes."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_t) / sw
    amp = rng.uniform(5.0, 50.0, n_voxels)[:, None]
    fids = np.zeros((n_voxels, n_t), complex)
    for (shift, lw), a in zip(PEAKS_31P, FIXED_AMPS_31P):
        sig = np.exp((-lw * np.pi + 2j * np.pi * shift * mhz) * t)
        fids += (amp if a is None else a) * sig[None, :]
    fids += rng.normal(0, 0.3, fids.shape) + 1j * rng.normal(0, 0.3, fids.shape)
    return fids.astype(np.complex64), t.astype(np.float32), amp[:, 0]


def spectral_constants(n_t=N_T, sw=SW, lb=5.0):
    """Window and centred frequency axis on the 2x zero-filled axis."""
    zf = 2 * n_t
    weight = np.exp(-np.pi * lb * np.arange(zf) / sw).astype(np.float32)
    freqs = np.fft.fftshift(np.fft.fftfreq(zf, d=1.0 / sw)).astype(np.float32)
    return zf, weight, freqs
