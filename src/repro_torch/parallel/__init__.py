"""Parallel execution of the port: the GPipe pipeline (one device or a stage
mesh), collectives, activation specs and sharding rules."""
