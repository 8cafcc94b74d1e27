"""Tiled matrix product: CUDA kernel, checked wrapper and plain version."""
