"""Checkpoints of torch tensor trees (``checkpoint.save`` / ``restore``)."""
