"""lm_iters_per_grid.k12: LM trips per request at K = 12, F = 48, the
program's counter ``lm.iterations`` (each trip of ``fitting/lm.py``'s
``_lm_loop``) over the traced run's profiled part (layer: fit)."""

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
