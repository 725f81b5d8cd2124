"""spd_inverse_roofline_pct: the least time of every
``KernelSet.spd_inverse_diag`` call (K4, ``csrc/spd.cu``, the grid's CRLB)
over the time its kernel ran, in % (layer: kernels).  The time is the
profiled part's CUDA records of ``KERNEL`` (the slab layout's
instantiation, one a call; K6b is the same template on ``Dense``); the
work is ``roofline.spd_inverse_work`` of the calls the slot of the
``KernelSet`` the entry passes as ``kernels=`` made there."""

KIND = "kernel"
SLOT = "spd_inverse_diag"
WORK = "spd_inverse_work"
KERNEL = r"\bspd_inverse_diag_kernel<\d+, [^<>]*\bSlabTile<"


def read(trace):
    return trace.roofline_pct(SLOT, KERNEL)
