"""Models of the port: the paper's VGG CNNs with their hybrid execution plan,
and the dense and hybrid (Mamba2 + shared attention) LMs with their serving
entry points."""
