"""Image reconstruction (PyTorch port): Cartesian k-space -> image space."""

from xmris_tpu_torch.recon.kspace import kspace_to_image, rss_combine, rss_reconstruct
from xmris_tpu_torch.recon.sense import (
    estimate_sensitivities,
    sense_combine,
    sense_reconstruct,
)

__all__ = [
    "kspace_to_image",
    "rss_combine",
    "rss_reconstruct",
    "estimate_sensitivities",
    "sense_combine",
    "sense_reconstruct",
]
