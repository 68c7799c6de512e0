# Copy of src/repro/configs/llava_next_mistral_7b.py; only the package name in imports differs.
"""LLaVA-NeXT (Mistral-7B backbone; anyres vision tiling is a STUB —
input_specs supplies precomputed patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf]"""
from repro_torch.models.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000, rope_theta=1e6,
    num_patches=576,  # one 24x24 tile; anyres adds tiles via the stub
))
