"""spd_inverse_roofline_pct.k12: the least time of every
``KernelSet.spd_inverse_diag`` call (K4 at F = 48, the grid's CRLB on
``csrc/spd.cu``'s wide factor, two rows a lane) over the time its kernel
ran, in % (layer: kernels).  The time is the profiled part's CUDA records
of ``KERNEL``, which matches the slab layout's wide instantiation only
(kF = 48; not the F <= 32 ones, nor K6b's ``Dense``), one a call; the
work is ``roofline.spd_inverse_work`` of the calls the slot made there."""

KIND = "kernel"
SLOT = "spd_inverse_diag"
WORK = "spd_inverse_work"
KERNEL = r"\bspd_inverse_diag_kernel<48, [^<>]*\bSlabTile<"


def read(trace):
    return trace.roofline_pct(SLOT, KERNEL)
