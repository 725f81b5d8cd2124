"""FID simulation from the AMARES Eq.6 forward model (PyTorch port).

Port of :mod:`xmris_tpu.fitting.simulation`, with the same physics and attrs
contract.  ppm inputs convert via ``(shift - carrier_ppm) *
reference_frequency``; optional complex Gaussian noise targets an SNR
measured on the mean magnitude of the first 10 points, with the variance
split equally between the real and imaginary channels.  The labeled
simulator is float64 NumPy on the host with noise from
``np.random.default_rng(seed)``, so it is bit for bit the reference's;
:func:`simulate_fid_raw` is the tensor form on its inputs' device.
"""

from __future__ import annotations

import numpy as np
import torch

from xmris_tpu_torch.core.array import XmrArray
from xmris_tpu_torch.core.config import ATTRS, COORDS, DIMS
from xmris_tpu_torch.models.lineshapes import eq6_fid


def _simulate_fid_ndarray(
    amplitudes,
    *,
    frequencies=None,
    chemical_shifts=None,
    reference_frequency: float | None = None,
    carrier_ppm: float = 0.0,
    spectral_width: float = 10000.0,
    n_points: int = 1024,
    dampings=50.0,
    phases=0.0,
    lineshape_g=0.0,
    dead_time: float = 0.0,
) -> np.ndarray:
    """Raw Eq.6 FID as a float64 host array, peak by peak."""
    amplitudes = np.atleast_1d(np.asarray(amplitudes, dtype=np.float64))
    n_peaks = len(amplitudes)

    if frequencies is not None and chemical_shifts is not None:
        raise ValueError("Provide either 'frequencies' or 'chemical_shifts', not both.")
    elif chemical_shifts is not None:
        if reference_frequency is None:
            raise ValueError(
                "reference_frequency (MHz) must be provided when using chemical shifts."
            )
        chemical_shifts = np.atleast_1d(np.asarray(chemical_shifts, dtype=np.float64))
        freqs = (chemical_shifts - carrier_ppm) * reference_frequency
    elif frequencies is not None:
        freqs = np.atleast_1d(np.asarray(frequencies, dtype=np.float64))
    else:
        raise ValueError("Either 'frequencies' or 'chemical_shifts' must be provided.")

    if len(freqs) != n_peaks:
        raise ValueError("Length of frequencies/chemical_shifts must match amplitudes.")

    dampings = np.broadcast_to(np.asarray(dampings, dtype=np.float64), (n_peaks,))
    phases = np.broadcast_to(np.asarray(phases, dtype=np.float64), (n_peaks,))
    g_arr = np.clip(
        np.broadcast_to(np.asarray(lineshape_g, dtype=np.float64), (n_peaks,)), 0.0, 1.0
    )

    t = np.arange(n_points, dtype=np.float64) / spectral_width + dead_time

    # Eq.6 per peak: a_k e^{i p_k} e^{(i 2 pi f_k - d_k (1 - g_k + g_k t)) t}.
    acc = np.zeros(n_points, dtype=np.complex128)
    for a_k, f_k, d_k, p_k, g_k in zip(amplitudes, freqs, dampings, phases, g_arr):
        envelope = np.exp(-d_k * (1.0 - g_k + g_k * t) * t)
        acc += a_k * envelope * np.exp(1j * (p_k + 2 * np.pi * f_k * t))
    return acc


def simulate_fid_raw(t, amplitudes, frequencies, dampings, phases, lineshape_g):
    """Eq.6 FID on tensors, on ``t``'s device and at its precision: the
    per-peak arguments broadcast to the number of amplitudes and g is
    clipped to [0, 1]."""
    t = torch.as_tensor(t)
    like = dict(dtype=t.dtype, device=t.device)
    a = torch.atleast_1d(torch.as_tensor(amplitudes, **like))
    k = a.shape[0]
    return eq6_fid(
        t,
        a,
        torch.atleast_1d(torch.as_tensor(frequencies, **like)),
        torch.broadcast_to(torch.as_tensor(dampings, **like), (k,)),
        torch.broadcast_to(torch.as_tensor(phases, **like), (k,)),
        torch.clamp(torch.broadcast_to(torch.as_tensor(lineshape_g, **like), (k,)),
                    0.0, 1.0),
    )


def simulate_fid(
    amplitudes,
    *,
    frequencies=None,
    chemical_shifts=None,
    reference_frequency: float | None = None,
    carrier_ppm: float = 0.0,
    spectral_width: float = 10000.0,
    n_points: int = 1024,
    dampings=50.0,
    phases=0.0,
    lineshape_g=0.0,
    dead_time: float = 0.0,
    target_snr: float | None = None,
    seed: int | None = None,
) -> XmrArray:
    """Simulate a complex FID as a vocabulary-compliant host :class:`XmrArray`
    (reference ``simulate_fid``; ``seed`` makes the noise reproducible)."""
    payload = _simulate_fid_ndarray(
        amplitudes=amplitudes,
        frequencies=frequencies,
        chemical_shifts=chemical_shifts,
        reference_frequency=reference_frequency,
        carrier_ppm=carrier_ppm,
        spectral_width=spectral_width,
        n_points=n_points,
        dampings=dampings,
        phases=phases,
        lineshape_g=lineshape_g,
        dead_time=dead_time,
    )

    if target_snr is not None:
        head_mag = np.mean(np.abs(payload[0 : min(10, n_points)]))
        per_channel = head_mag / target_snr / np.sqrt(2)
        rng = np.random.default_rng(seed)
        payload = payload + per_channel * (
            rng.normal(size=payload.shape) + 1j * rng.normal(size=payload.shape)
        )

    taxis = np.arange(n_points, dtype=np.float64) / spectral_width + dead_time

    attrs = {
        "spectral_width": spectral_width,
        "dead_time": dead_time,
        "sim_amplitudes": np.atleast_1d(amplitudes).tolist(),
        "sim_dampings": np.atleast_1d(dampings).tolist(),
        ATTRS.carrier_ppm: carrier_ppm,
        "units": "a.u.",
    }
    if target_snr is not None:
        attrs["target_snr"] = target_snr
    if reference_frequency is not None:
        attrs[ATTRS.reference_frequency] = reference_frequency
    if frequencies is not None:
        attrs["sim_frequencies_hz"] = np.atleast_1d(frequencies).tolist()
    if chemical_shifts is not None:
        attrs["sim_chemical_shifts_ppm"] = np.atleast_1d(chemical_shifts).tolist()

    return XmrArray(
        data=payload,
        dims=[DIMS.time],
        coords={COORDS.time: (DIMS.time, taxis, {"units": "s", "long_name": "Time"})},
        attrs=attrs,
        name="FID Signal",
    )
