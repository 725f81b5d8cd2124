"""Spectral operations and the hand-written kernels (PyTorch port)."""

from xmris_tpu_torch.ops.baseline import als_baseline_batched, als_baseline_raw, baseline_als
from xmris_tpu_torch.ops.fid import apodize_exp, apodize_lg, to_fid, to_spectrum, zero_fill
from xmris_tpu_torch.ops.fourier import (
    fft,
    fftc,
    fftn_ortho,
    fftshift,
    ifft,
    ifftc,
    ifftn_ortho,
    ifftshift,
)
from xmris_tpu_torch.ops.optim import DEResult, differential_evolution
from xmris_tpu_torch.ops.phasing import (
    acme_score_raw,
    autophase,
    peak_minima_score_raw,
    phase,
    phase_factor_raw,
    roi_positivity_score_raw,
)
from xmris_tpu_torch.ops.utils import to_complex, to_real_imag

__all__ = [
    "DEResult",
    "acme_score_raw",
    "als_baseline_batched",
    "als_baseline_raw",
    "apodize_exp",
    "apodize_lg",
    "autophase",
    "baseline_als",
    "differential_evolution",
    "fft",
    "fftc",
    "fftn_ortho",
    "fftshift",
    "ifft",
    "ifftc",
    "ifftn_ortho",
    "ifftshift",
    "peak_minima_score_raw",
    "phase",
    "phase_factor_raw",
    "roi_positivity_score_raw",
    "to_complex",
    "to_fid",
    "to_real_imag",
    "to_spectrum",
    "zero_fill",
]
