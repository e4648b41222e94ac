"""Data pipeline: deterministic synthetic token streams with a device prefetch."""
