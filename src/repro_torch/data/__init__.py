"""Synthetic datasets and the λ non-iid partitioner (numpy-only copies)."""
