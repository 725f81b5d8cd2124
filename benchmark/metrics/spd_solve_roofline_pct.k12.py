"""spd_solve_roofline_pct.k12: the least time of every
``KernelSet.spd_solve_damped`` call (K3 at F = 48, the LM's damped step on
``csrc/spd.cu``'s wide factor, two rows a lane) over the time its kernel
ran, in % (layer: kernels).  The time is the profiled part's CUDA records
of ``KERNEL``, which matches the slab layout's wide instantiation only
(kF = 48; the F <= 32 ones and K6a's ``Dense`` do not match), one a
call; the work is ``roofline.spd_solve_work`` of the calls the slot of the
``KernelSet`` the entry passes as ``kernels=`` made there."""

KIND = "kernel"
SLOT = "spd_solve_damped"
WORK = "spd_solve_work"
KERNEL = r"\bspd_solve_damped_kernel<48, [^<>]*\bSlabTile<"


def read(trace):
    return trace.roofline_pct(SLOT, KERNEL)
