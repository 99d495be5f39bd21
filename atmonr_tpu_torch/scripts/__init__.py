"""Command-line entry points of the port (run as ``python -m``)."""
