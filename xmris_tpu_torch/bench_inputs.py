"""The bench configuration and phantom, numpy only.

A copy of ``bench.py:33-84`` for the PyTorch port (``bench.py`` imports jax
at module top): a 32x32x16 grid of 1024-point 31P FIDs with five peaks
(PCr amplitude varying per voxel), zero-filled to 2048 with an lb = 5
window, and the 5-peak Lorentzian prior (20 free parameters, g fixed at 0).
"""

from __future__ import annotations

import numpy as np

GRID = (32, 32, 16)
N_TIME = 1024
ZERO_FILL = 2048
SW = 5000.0
MHZ = 120.0

PK_CSV = """Index,PCr,gATP,aATP,bATP,Pi
Initial Values,,,,,
amplitude,10.0,5.0,5.0,4.0,3.0
chemicalshift,0.0,-2.5,-7.5,-16.1,4.8
linewidth,15.0,20.0,20.0,25.0,15.0
phase,0,0,0,0,0
g,0,0,0,0,0
Bounds,,,,,
amplitude,"(0, ","(0, ","(0, ","(0, ","(0, "
chemicalshift,"(-0.5, 0.5)","(-3.0, -2.0)","(-8.0, -7.0)","(-16.6, -15.6)","(4.3, 5.3)"
linewidth,"(5.0, 30.0)","(10.0, 40.0)","(10.0, 40.0)","(10.0, 45.0)","(5.0, 30.0)"
phase,"(-180, 180)","(-180, 180)","(-180, 180)","(-180, 180)","(-180, 180)"
g,fixed,fixed,fixed,fixed,fixed
"""

# Ground-truth peak table of make_inputs: (shift ppm, linewidth Hz)
PEAKS_31P = (
    (0.0, 14.0),  # PCr — amplitude varies per voxel
    (-2.5, 19.0),  # gamma-ATP
    (-7.5, 21.0),  # alpha-ATP
    (-16.1, 26.0),  # beta-ATP
    (4.8, 13.0),  # Pi
)
FIXED_AMPS_31P = (None, 6.0, 6.0, 5.0, 3.5)  # None => per-voxel PCr amp


def pcr_amplitudes(grid=GRID) -> np.ndarray:
    """The per-voxel ground-truth PCr amplitudes of :func:`make_inputs`."""
    rng = np.random.default_rng(0)
    return rng.uniform(5.0, 50.0, size=int(np.prod(grid)))


def make_inputs(grid=GRID, g=0.0):
    """A 5-peak 31P phantom over ``grid``: ``(fids complex64 (B, N_TIME),
    weight float32 (ZERO_FILL,), freqs float32 (ZERO_FILL,))``.  At the
    default grid and ``g = 0`` it is bit-for-bit ``bench.make_inputs()``;
    ``g > 0`` gives every peak the Eq. 6 Voigt envelope
    ``exp(-pi lw (1 - g + g t) t)`` with that mixing fraction."""
    n_voxels = int(np.prod(grid))
    rng = np.random.default_rng(0)
    t = np.arange(N_TIME) / SW
    amp_pcr = rng.uniform(5.0, 50.0, size=n_voxels)[:, None]
    fids = np.zeros((n_voxels, N_TIME), dtype=np.complex128)
    for (shift, lw), amp in zip(PEAKS_31P, FIXED_AMPS_31P):
        if g:
            sig = (np.exp(-lw * np.pi * (1 - g + g * t) * t)
                   * np.exp(1j * 2 * np.pi * (shift * MHZ) * t))
        else:
            sig = np.exp((-lw * np.pi + 1j * 2 * np.pi * (shift * MHZ)) * t)
        fids += (amp_pcr if amp is None else amp) * sig[None, :]
    fids += rng.normal(0, 0.3, fids.shape) + 1j * rng.normal(0, 0.3, fids.shape)

    t_full = np.arange(ZERO_FILL) / SW
    weight = np.exp(-np.pi * 5.0 * t_full).astype(np.float32)
    freqs = np.fft.fftshift(np.fft.fftfreq(ZERO_FILL, d=1.0 / SW)).astype(
        np.float32
    )
    return fids.astype(np.complex64), weight, freqs


# ---------------------------------------------------------------------------
# Multi-coil phantoms of the recon path (``tests/test_recon.py``'s, in N-D)
# ---------------------------------------------------------------------------

N_COILS = 8


def scaled_grid(shape):
    """Index coordinates of ``shape`` scaled to the longest axis L, so that
    every axis spans [0, L) (for equal sizes, the plain indices)."""
    big = max(shape)
    return [g * (big / n) for g, n in zip(np.mgrid[tuple(slice(0, n) for n in shape)],
                                           shape)], big


def coil_sensitivities(shape, n_coils=N_COILS):
    """``n_coils`` smooth complex coil maps over ``shape`` (coil first):
    Gaussian blobs of width 0.8 L at uniformly drawn centres with a uniform
    random phase, drawn from seed 5 as ``tests/test_recon.py:120-127`` draws
    them (for a square 2-D ``shape`` the same maps)."""
    rng = np.random.default_rng(5)
    axes, big = scaled_grid(shape)
    coils = []
    for _ in range(n_coils):
        centre = rng.uniform(0, big, len(shape))  # the last axis first
        d2 = sum((axes[a] - centre[len(shape) - 1 - a]) ** 2
                 for a in reversed(range(len(shape))))
        sens = np.exp(-(d2 / (2 * (big * 0.8) ** 2)))
        coils.append(sens * np.exp(1j * rng.uniform(0, 2 * np.pi)))
    return np.stack(coils)


def unit_rss_coil_maps(shape=GRID, n_coils=N_COILS):
    """:func:`coil_sensitivities` normalized to a unit root-sum-of-squares."""
    sens = coil_sensitivities(shape, n_coils)
    return sens / np.sqrt(np.sum(np.abs(sens) ** 2, axis=0, keepdims=True))


def centered_fftn(img, axes):
    """``fftshift(fftn(ifftshift(img), ortho))`` over ``axes`` (numpy)."""
    return np.fft.fftshift(
        np.fft.fftn(np.fft.ifftshift(img, axes=axes), axes=axes, norm="ortho"),
        axes=axes)


def coil_kspace_phantom(shape, n_coils=N_COILS):
    """``tests/test_recon.py::make_kspace_with_sens`` (seed 5, no noise) over
    ``shape``: an ellipsoid of 1 (semi-axes a quarter of each size) plus a
    0.3 block, times :func:`coil_sensitivities`, to centered k-space.
    Returns ``(kspace (coil, *shape) complex128, phantom, sens)``."""
    axes, big = scaled_grid(shape)
    r2 = sum((axes[a] - big / 2) ** 2 for a in reversed(range(len(shape))))
    phantom = (r2 < (big / 4) ** 2).astype(float)
    half = [5] + [3] * (len(shape) - 1)  # tests/test_recon.py: |y| < 5, |x| < 3
    block = np.ones(shape, bool)
    for a in range(len(shape)):
        block &= np.abs(axes[a] - big / 4) < half[a]
    phantom = phantom + 0.3 * block
    sens = coil_sensitivities(shape, n_coils)
    spatial = tuple(range(1, len(shape) + 1))
    return centered_fftn(sens * phantom[None], spatial), phantom, sens
