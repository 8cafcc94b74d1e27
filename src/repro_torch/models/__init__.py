"""Models of the port: the paper's VGG CNNs and their hybrid execution plan."""
