# Copy of src/repro/configs/starcoder2_15b.py; only the package name in imports differs.
"""StarCoder2-15B (dense GQA, RoPE). [arXiv:2402.19173]"""
from repro_torch.models.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="starcoder2-15b", family="dense",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4,
    d_ff=24576, vocab_size=49152, rope_theta=1e5,
))
