"""Execution schedules of the port: the GPipe microbatch pipeline."""
