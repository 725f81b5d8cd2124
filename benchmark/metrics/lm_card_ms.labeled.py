"""lm_card_ms.labeled: card ms per request in the labeled fit's ``fit``
stage (both LM passes and the numpy round trip between them), from the
program's span ``fit_amares.fit``: CUDA events at the span's edges, no
sync, over the traced run's profiled part (layer: labeled fit)."""

KIND = "profile"
SPAN = "fit_amares.fit"


def read(trace):
    try:
        from xmris_tpu_torch.runtime.profiling import snapshot
    except ImportError:  # a program without the recorder
        return None
    got = snapshot()["spans"].get(SPAN)
    if not trace.profile_requests or not got or got["card_ms"] is None:
        return None
    return got["card_ms"] / trace.profile_requests
