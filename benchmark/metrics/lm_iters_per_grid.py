"""lm_iters_per_grid: LM trips per request, the program's counter
``lm.iterations`` (each trip of ``fitting/lm.py``'s ``_lm_loop`` and of
``lm_fit_batched_planar``'s loop, the template fit's too) over the traced
run's profiled part (layer: fit)."""

KIND = "profile"
COUNTER = "lm.iterations"


def read(trace):
    try:
        from xmris_tpu_torch.runtime.profiling import snapshot
    except ImportError:  # a program without the recorder
        return None
    n = snapshot()["counters"].get(COUNTER)
    if not trace.profile_requests or n is None:
        return None
    return n / trace.profile_requests
