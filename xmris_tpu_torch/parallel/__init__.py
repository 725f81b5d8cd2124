"""The fused per-grid program (PyTorch port)."""
