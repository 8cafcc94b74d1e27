"""Entry points of the port: the command lines, and the meshes and ranks
they run on."""
