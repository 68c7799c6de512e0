"""Data pipelines of the training port (``pipeline.SyntheticTokens``)."""
