"""Plain PyTorch oracles for the ported kernels, under the reference's
names (port of src/repro/kernels/ref.py: ``matmul_ref``, ``attention_ref``,
``ffn_ref`` and ``ssd_chunk_ref``, with the same cast points), and
``matmul_quant_ref`` for the dequant-fused matmul (the reference checks
its kernel against ``matmul_ref`` on the dequantized B).  They are the
plain versions that live beside each kernel."""
from repro_torch.kernels.block_fused_ffn import block_fused_ffn_plain as ffn_ref
from repro_torch.kernels.cache_matmul import cache_matmul_plain as matmul_ref
from repro_torch.kernels.cache_matmul import \
    cache_matmul_quant_plain as matmul_quant_ref
from repro_torch.kernels.flash_attention import flash_attention_plain as attention_ref
from repro_torch.kernels.ssd_scan import ssd_chunk_plain as ssd_chunk_ref

__all__ = ["attention_ref", "ffn_ref", "matmul_quant_ref", "matmul_ref",
           "ssd_chunk_ref"]
