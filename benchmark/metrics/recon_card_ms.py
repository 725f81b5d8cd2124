"""recon_card_ms: card ms per request in the k-space recon, from the
program's span ``recon`` around ``recon/kspace.py::kspace_to_image`` and
``recon/sense.py::sense_combine`` (summed): CUDA events at the span's
edges, no sync, over the traced run's profiled part (layer: recon).  The
synced twin from outside is ``recon_ms``."""

KIND = "profile"
SPAN = "recon"


def read(trace):
    try:
        from xmris_tpu_torch.runtime.profiling import snapshot
    except ImportError:  # a program without the recorder
        return None
    got = snapshot()["spans"].get(SPAN)
    if not trace.profile_requests or not got or got["card_ms"] is None:
        return None
    return got["card_ms"] / trace.profile_requests
