"""Command-line entry points of the port (wise_tpu/cli): the same argument
surfaces on the port's factories."""
