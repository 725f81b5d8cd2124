"""spd_solve_roofline_pct: the least time of every
``KernelSet.spd_solve_damped`` call (K3, ``csrc/spd.cu``, the LM's damped
step) over the time its kernel ran, in % (layer: kernels).  The time is
the profiled part's CUDA records of ``KERNEL`` (the slab layout's
instantiation, one a call; K6a is the same template on ``Dense``); the
work is ``roofline.spd_solve_work`` of the calls the slot of the
``KernelSet`` the entry passes as ``kernels=`` made there."""

KIND = "kernel"
SLOT = "spd_solve_damped"
WORK = "spd_solve_work"
KERNEL = r"\bspd_solve_damped_kernel<\d+, [^<>]*\bSlabTile<"


def read(trace):
    return trace.roofline_pct(SLOT, KERNEL)
