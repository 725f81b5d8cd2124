"""fit_ms.labeled: ms per request in the labeled fit, a synced span around
``fitting/amares.py::fit_amares`` as the ``.xmr`` accessor calls it
(layer: labeled fit)."""

KIND = "span"
WRAPS = ("xmris_tpu_torch.fitting.amares:fit_amares",)


def read(trace):
    return trace.span_ms(WRAPS)
