"""Model stack of the port: dense, MoE, SSM, hybrid, encoder-decoder
and VLM families."""
