"""Deterministic synthetic workloads (numpy generators)."""
