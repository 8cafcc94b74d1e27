"""Models of the port: the paper's VGG CNNs with their hybrid execution plan,
and the dense decoder-only LM with its serving entry points."""
