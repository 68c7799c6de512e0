# Port of src/repro/models/base.py: the same ArchConfig, with a torch dtype
# property (torch_dtype) in place of the JAX one (jdtype).
"""Architecture config system for the assigned model zoo.

Every architecture is a single :class:`ArchConfig`; families share one
composable block stack (models/transformer.py) parameterized by a
per-layer *block pattern* (attention+FFN, MoE, Mamba2/SSD, hybrid,
encoder-decoder).  ``reduced()`` returns the CPU-smoke-test variant of
the same family (small widths, few layers/experts, tiny vocab).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # --- hybrid (Zamba2-style): 1 shared attention block every N layers ---
    attn_every: int = 0          # 0 -> pure (all-attn or all-ssm per family)
    # --- encoder-decoder (Whisper-style) ---
    enc_layers: int = 0
    enc_len: int = 1500          # fixed audio-frame count (stub frontend)
    # --- VLM ---
    num_patches: int = 0         # prefix patch embeddings (stub frontend)
    # --- attention behaviour ---
    sliding_window: int = 0      # 0 -> full attention
    sub_quadratic: bool = False  # eligible for long_500k
    rope_theta: float = 1e6
    # --- numerics ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5

    def __post_init__(self):
        if self.num_heads and self.num_heads % max(1, self.num_kv_heads):
            raise ValueError(f"{self.name}: num_heads must divide by kv heads")

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.num_heads))

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 256 so the vocab dim
        shards over any mesh axis (Megatron-style padding; §Perf cell A:
        unshardable vocabs replicate the full logits tensor per chip).
        Logits for padding ids are masked in the loss/decode paths."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D)."""
        d, L = self.d_model, self.num_layers
        emb = self.vocab_size * d
        attn = d * (self.num_heads * self.hd) + 2 * d * (self.num_kv_heads * self.hd) \
            + (self.num_heads * self.hd) * d
        if self.is_moe:
            ffn = self.num_experts * 3 * d * self.d_ff + d * self.num_experts
        else:
            ffn = 3 * d * self.d_ff
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            ssm = d * (2 * di + 2 * ns + nh) + di * d + di  # in/out proj + dt/B/C
        if self.family == "ssm":
            layer = ssm
        elif self.family == "hybrid":
            # Zamba2-style: ONE shared attention+FFN block reused by every
            # group; only the Mamba2 layers are per-layer parameters.
            groups = L // max(1, self.attn_every)
            n_ssm = L - groups
            return emb + n_ssm * ssm + (attn + ffn) + emb
        else:
            layer = attn + ffn
        total = emb + L * layer + emb  # embed + layers + unembed
        if self.family == "encdec":
            total += self.enc_layers * (attn + 3 * d * self.d_ff) + L * attn  # cross-attn
        return total

    def active_param_count(self) -> int:
        """N_active for MoE (top-k of E experts)."""
        if not self.is_moe:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        emb = self.vocab_size * d
        attn = d * (self.num_heads * self.hd) + 2 * d * (self.num_kv_heads * self.hd) \
            + (self.num_heads * self.hd) * d
        ffn_active = self.experts_per_token * 3 * d * self.d_ff + d * self.num_experts
        return emb + L * (attn + ffn_active) + emb

    def reduced(self) -> "ArchConfig":
        """CPU smoke-test variant: same family/topology, tiny sizes."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2 if not self.attn_every
                           else self.attn_every),
            d_model=128,
            num_heads=4,
            num_kv_heads=max(1, min(4, self.num_kv_heads)),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            num_experts=min(self.num_experts, 4) if self.is_moe else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.is_moe else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=32 if self.ssm_state else 256,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            enc_layers=min(self.enc_layers, 2),
            enc_len=16 if self.family in ("encdec", "audio") else 1500,
            num_patches=8 if self.num_patches else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            dtype="float32",
        )


_REGISTRY: Dict[str, "ArchConfig"] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if not _REGISTRY:
        import repro_torch.configs  # noqa: F401  (populates the registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_archs() -> Dict[str, ArchConfig]:
    if not _REGISTRY:
        import repro_torch.configs  # noqa: F401
    return dict(_REGISTRY)
