"""Plain PyTorch oracles for the ported kernels, under the reference's
names (port of src/repro/kernels/ref.py: ``matmul_ref`` and ``ffn_ref``,
with the same cast points).  They are the plain versions that live beside
each kernel.  ``attention_ref`` and ``ssd_chunk_ref`` come with the
kernels that need them."""
from repro_torch.kernels.block_fused_ffn import block_fused_ffn_plain as ffn_ref
from repro_torch.kernels.cache_matmul import cache_matmul_plain as matmul_ref

__all__ = ["ffn_ref", "matmul_ref"]
