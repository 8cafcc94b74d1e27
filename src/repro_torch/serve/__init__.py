"""Serving of the port: continuous batching over the LM's decode step."""
