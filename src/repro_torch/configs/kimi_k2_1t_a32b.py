# Copy of src/repro/configs/kimi_k2_1t_a32b.py; only the package name in imports differs.
"""Kimi K2 (trillion-param MoE: 384 experts, top-8, per-expert d_ff 2048).
[arXiv:2501.kimi2 paper-table]  All 61 layers MoE per the assigned spec."""
from repro_torch.models.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    head_dim=112,  # 7168 / 64
    d_ff=2048, vocab_size=163840,
    num_experts=384, experts_per_token=8,
))
