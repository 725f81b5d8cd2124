"""Fitting and simulation (PyTorch port): the Eq.6 simulator, AMARES prior
parsing, seeding and the batched LM."""

from xmris_tpu_torch.fitting.simulation import simulate_fid, simulate_fid_raw


def __getattr__(name):
    # Lazy: the fitter pulls in the LM engine and the kernel wrappers.
    if name in ("fit_amares", "stage_device_fids", "StagedFids"):
        from xmris_tpu_torch.fitting import amares

        return getattr(amares, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "StagedFids",
    "fit_amares",
    "simulate_fid",
    "simulate_fid_raw",
    "stage_device_fids",
]
