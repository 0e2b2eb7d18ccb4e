"""Batched serving helpers (PyTorch port)."""
