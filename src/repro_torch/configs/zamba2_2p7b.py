# Copy of src/repro/configs/zamba2_2p7b.py; only the package name in imports differs.
"""Zamba2-2.7B (hybrid: Mamba2 backbone + shared attention blocks).
[arXiv:2411.15242]  attn_every=6 -> 9 attention blocks over 54 layers.
Runs long_500k: the SSM path is linear; the shared attention blocks use
a sliding window at long context (DESIGN.md SArch-applicability)."""
from repro_torch.models.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    attn_every=6, sliding_window=4096, sub_quadratic=True,
))
