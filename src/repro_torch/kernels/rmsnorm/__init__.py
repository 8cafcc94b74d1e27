"""Fused RMSNorm: CUDA kernel, checked wrapper and plain version."""
