"""Optimizers of the training port (``adamw``)."""
