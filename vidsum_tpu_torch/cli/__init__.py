"""Command-line entry points of the port (``python -m
vidsum_tpu_torch.cli.<name>``)."""
