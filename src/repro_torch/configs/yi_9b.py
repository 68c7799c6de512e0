# Copy of src/repro/configs/yi_9b.py; only the package name in imports differs.
"""Yi-9B (dense, llama-arch GQA). [arXiv:2403.04652]"""
from repro_torch.models.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="yi-9b", family="dense",
    num_layers=48, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11008, vocab_size=64000, rope_theta=5e6,
))
