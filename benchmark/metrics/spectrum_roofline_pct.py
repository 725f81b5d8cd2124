"""spectrum_roofline_pct: the least time of every ``KernelSet.spectrum``
call (K1, ``csrc/spectrum.cu``) over the time its kernel ran, in % (layer:
kernels).  The time is the profiled part's CUDA records of ``KERNEL``
(either of K1's two kernels, one a call); the work is
``roofline.spectrum_work`` of the calls the slot of the ``KernelSet`` the
entry passes as ``kernels=`` made there."""

KIND = "kernel"
SLOT = "spectrum"
WORK = "spectrum_work"
KERNEL = r"\bspectrum(_fft)?_kernel\("


def read(trace):
    return trace.roofline_pct(SLOT, KERNEL)
