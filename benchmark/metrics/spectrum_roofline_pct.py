"""spectrum_roofline_pct: the least time of every ``KernelSet.spectrum``
call (K1, ``csrc/spectrum.cu``) over the time CUDA events read around it,
in % (layer: kernels).  Wraps the slot of the ``KernelSet`` the entry
passes as ``kernels=``; the work is ``roofline.spectrum_work``."""

KIND = "kernel"
SLOT = "spectrum"
WORK = "spectrum_work"


def read(trace):
    return trace.roofline_pct(SLOT)
