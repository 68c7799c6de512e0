# Copy of src/repro/configs/__init__.py; only the package name in imports differs.
"""Assigned-architecture configs; importing this module populates the
registry (repro.models.base.get_arch / all_archs)."""
from repro_torch.configs import (granite_3_8b, kimi_k2_1t_a32b,
                           llava_next_mistral_7b, mamba2_370m,
                           mistral_nemo_12b, olmoe_1b_7b, starcoder2_15b,
                           whisper_tiny, yi_9b, zamba2_2p7b)

ARCH_IDS = [
    "mistral-nemo-12b", "yi-9b", "starcoder2-15b", "granite-3-8b",
    "whisper-tiny", "zamba2-2.7b", "llava-next-mistral-7b",
    "kimi-k2-1t-a32b", "olmoe-1b-7b", "mamba2-370m",
]
