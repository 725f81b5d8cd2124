"""recon_ms: ms per request in the k-space recon, synced spans around
``recon/kspace.py::kspace_to_image`` and ``recon/sense.py::sense_combine``
summed (layer: recon)."""

KIND = "span"
WRAPS = ("xmris_tpu_torch.recon.kspace:kspace_to_image",
         "xmris_tpu_torch.recon.sense:sense_combine")


def read(trace):
    return trace.span_ms(WRAPS)
