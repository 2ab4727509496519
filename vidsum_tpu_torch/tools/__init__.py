"""Tools that measure the port on the card (``python -m
vidsum_tpu_torch.tools.<name>``)."""
