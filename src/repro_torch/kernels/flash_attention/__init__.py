"""Flash attention: CUDA kernel, checked wrappers and plain version."""
