# Copy of src/repro/configs/whisper_tiny.py; only the package name in imports differs.
"""Whisper-tiny (encoder-decoder; conv audio frontend is a STUB —
input_specs supplies precomputed frame embeddings). [arXiv:2212.04356]

seq_len in the assigned shapes applies to the DECODER token stream;
the encoder operates on the fixed 1500-frame (30 s) window.
"""
from repro_torch.models.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-tiny", family="encdec",
    num_layers=4, enc_layers=4, enc_len=1500,
    d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51865, rope_theta=1e4,
))
