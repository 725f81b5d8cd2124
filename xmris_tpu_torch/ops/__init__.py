"""Spectral operations and the hand-written kernels (PyTorch port)."""
