"""Checkpoints of the port: atomic snapshots in the JAX package's layout."""
