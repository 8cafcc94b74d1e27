"""PyTorch and CUDA port of the JAX runtime in ``repro``, for NVIDIA Hopper.

The JAX package is the reference and stays as it is; this package mirrors
its layout (``core``, ``kernels``, ``models``, ``parallel``) and imports
nothing of it. Importing it needs neither CUDA nor ``nvcc``: the CUDA
kernels are built on their first launch (``kernels/_build.py``).
"""
