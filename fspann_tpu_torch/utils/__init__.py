"""Shared utilities: profiling, metrics, device-memory budget."""
