"""Direct 2-D convolution: CUDA kernel, checked wrapper and plain version."""
