"""Decode attention on a KV cache updated in place: CUDA kernels, checked wrappers and plain versions."""
