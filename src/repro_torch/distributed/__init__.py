"""Fault-tolerance pieces the serving port uses (``StragglerPolicy``)."""
