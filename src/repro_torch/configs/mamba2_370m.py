# Copy of src/repro/configs/mamba2_370m.py; only the package name in imports differs.
"""Mamba2-370M (attn-free SSD). [arXiv:2405.21060]  Runs long_500k:
linear-time state-space scan, O(1) decode state."""
from repro_torch.models.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    sub_quadratic=True,
))
