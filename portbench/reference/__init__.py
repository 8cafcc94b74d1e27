"""Plain PyTorch references of the benchmark's model families, one module a
family (named by a configuration file's ``reference`` key). Each has
``make_weights(arch, init, gen, dtype)`` and ``logits(weights, arch, tokens,
eps=, precision=)``. They import nothing of the program under test."""
