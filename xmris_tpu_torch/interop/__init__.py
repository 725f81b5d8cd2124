"""Interop with external array ecosystems (xarray, netCDF) of the PyTorch
port."""
