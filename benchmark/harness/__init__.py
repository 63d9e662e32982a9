"""The harness of the port's benchmark (see benchmark/README.md)."""
