"""Data of the port: the deterministic synthetic token pipeline."""
