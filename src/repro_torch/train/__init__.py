"""Training of the port: the step builders and the fault-tolerant Trainer."""
