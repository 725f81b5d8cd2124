"""normal_eq_roofline_pct: the least time of every
``KernelSet.normal_equations`` call (K2, ``csrc/lm_v9.cu``) over the time
CUDA events read around it, in % (layer: kernels).  Wraps the slot of the
``KernelSet`` the entry passes as ``kernels=``; the work is
``roofline.normal_equations_work``, which counts only the voxels the LM
still iterates and, past the accept gate, only the cost of a rejected
one."""

KIND = "kernel"
SLOT = "normal_equations"
WORK = "normal_equations_work"


def read(trace):
    return trace.roofline_pct(SLOT)
