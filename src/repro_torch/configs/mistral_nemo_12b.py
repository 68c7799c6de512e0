# Copy of src/repro/configs/mistral_nemo_12b.py; only the package name in imports differs.
"""Mistral-Nemo-Base-2407 (12B dense GQA). [hf:mistralai/Mistral-Nemo-Base-2407]"""
from repro_torch.models.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mistral-nemo-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    head_dim=128,  # Nemo uses explicit head_dim 128 (not d_model/heads)
    d_ff=14336, vocab_size=131072, rope_theta=1e6,
))
