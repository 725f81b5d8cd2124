"""fit_ms.grid: ms per request in the seeded fit of the fused grid program
(seeding, LM, CRLB), a synced span around
``fitting/amares.py::seeded_fit_grid_raw`` as ``process_grid_planar_raw``
calls it (layer: fit)."""

KIND = "span"
WRAPS = ("xmris_tpu_torch.parallel.process:seeded_fit_grid_raw",)


def read(trace):
    return trace.span_ms(WRAPS)
