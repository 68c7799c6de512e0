# Copy of src/repro/configs/granite_3_8b.py; only the package name in imports differs.
"""Granite-3.0-8B-base (dense GQA). [hf:ibm-granite/granite-3.0-8b-base]"""
from repro_torch.models.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-3-8b", family="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=12800, vocab_size=49155, rope_theta=1e4,
))
