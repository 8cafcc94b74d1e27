"""Mamba2 SSD chunked scan: CUDA kernel, checked wrapper and plain version."""
