"""AMARES prior parsing, seeding and the batched LM (PyTorch port)."""
