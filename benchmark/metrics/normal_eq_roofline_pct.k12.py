"""normal_eq_roofline_pct.k12: the least time of every
``KernelSet.normal_equations`` call (K2 at K = 12, F = 48: the wide build,
``csrc/lm_v9_wide.cu``) over the time CUDA events read around it, in %
(layer: kernels).  As ``normal_eq_roofline_pct``: it wraps the slot of the
``KernelSet`` the entry passes as ``kernels=``, and the work is
``roofline.normal_equations_work``, which counts only the voxels the LM
still iterates and, past the accept gate, only the cost of a rejected one
(read from the card's masks, so the time is the events')."""

KIND = "kernel"
SLOT = "normal_equations"
WORK = "normal_equations_work"


def read(trace):
    return trace.roofline_pct(SLOT)
