"""Processing namespace: the reference's ``xmris.processing`` layout over the
port's :mod:`xmris_tpu_torch.ops`, so imports like
``from xmris_tpu_torch.processing.fid import to_spectrum`` translate 1:1."""

from xmris_tpu_torch.ops import baseline, fid, fourier, phasing, utils
from xmris_tpu_torch.ops.baseline import baseline_als
from xmris_tpu_torch.ops.fid import apodize_exp, apodize_lg, to_fid, to_spectrum, zero_fill
from xmris_tpu_torch.ops.fourier import fft, fftc, fftshift, ifft, ifftc, ifftshift
from xmris_tpu_torch.ops.phasing import autophase, phase
from xmris_tpu_torch.ops.utils import to_complex, to_real_imag

__all__ = [
    "apodize_exp",
    "apodize_lg",
    "autophase",
    "baseline",
    "baseline_als",
    "fft",
    "fftc",
    "fftshift",
    "fid",
    "fourier",
    "ifft",
    "ifftc",
    "ifftshift",
    "phase",
    "phasing",
    "to_complex",
    "to_fid",
    "to_real_imag",
    "to_spectrum",
    "utils",
    "zero_fill",
]
