"""Spectral lineshape model families (PyTorch port): AMARES Eq.6."""

from xmris_tpu_torch.models.lineshapes import eq6_fid, eq6_fid_multi

__all__ = ["eq6_fid", "eq6_fid_multi"]
