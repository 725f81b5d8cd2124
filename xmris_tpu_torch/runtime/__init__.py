"""Runtime configuration of the PyTorch port (default dtypes)."""
