"""Model stack of the port (dense family in this slice)."""
