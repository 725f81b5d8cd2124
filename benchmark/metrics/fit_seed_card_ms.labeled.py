"""fit_seed_card_ms.labeled: card ms per request in the labeled fit's
``seed`` stage (the upload, the template fit, the LS seed), from the
program's span ``fit_amares.seed``: CUDA events at the span's edges, no
sync, over the traced run's profiled part (layer: labeled fit)."""

KIND = "profile"
SPAN = "fit_amares.seed"


def read(trace):
    try:
        from xmris_tpu_torch.runtime.profiling import snapshot
    except ImportError:  # a program without the recorder
        return None
    got = snapshot()["spans"].get(SPAN)
    if not trace.profile_requests or not got or got["card_ms"] is None:
        return None
    return got["card_ms"] / trace.profile_requests
