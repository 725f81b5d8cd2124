"""Labeled-array carrier, vocabulary and validation of the PyTorch port."""
