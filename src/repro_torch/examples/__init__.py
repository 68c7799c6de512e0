"""Example scripts of the port (``python -m repro_torch.examples.<name>``)."""
