"""CaMDN core, copied from the JAX package (framework-free scheduling:
shared cache, cache-aware mapping, dynamic allocation, NEC, KernelPlan
lowering, and ``codegen``, which unrolls a mapping candidate into NEC
commands for the simulator and the mapper's DRAM-model check)."""
from repro_torch.core.allocator import DynamicCacheAllocator, Selection, TaskProfile
from repro_torch.core.cache import CacheConfig, SharedCache
from repro_torch.core.codegen import generate_gemm_program, run_candidate
from repro_torch.core.cpt import CachePageTable, CptFault
from repro_torch.core.lbm import LbmConfig, build_model_mapping, segment_blocks
from repro_torch.core.mapping import MapperConfig, build_mct, map_layer_lwm
from repro_torch.core.mct import (MCT, CacheMapEntry, LoopTable, MappingCandidate,
                                  ModelMapping, Residency)
from repro_torch.core.nec import Nec, NecError, Traffic, TrafficLedger
from repro_torch.core.plan import (AttnPlan, FfnPlan, KernelPlan, lower_ffn,
                                   lower_selection)
from repro_torch.core.policy import (CachePolicy, CamdnPolicy, ExecutionPlan,
                                     StaticQuotaPolicy)
from repro_torch.core.runtime import TenantModel, TenantTask
from repro_torch.core.types import GemmDims, LayerKind, LayerSpec, ModelGraph

__all__ = [
    "CacheConfig", "SharedCache", "generate_gemm_program", "run_candidate",
    "CachePageTable", "CptFault", "Nec",
    "NecError", "Traffic", "MapperConfig", "build_mct", "map_layer_lwm",
    "LbmConfig", "build_model_mapping", "segment_blocks", "MCT",
    "MappingCandidate", "ModelMapping", "LoopTable", "CacheMapEntry",
    "Residency", "DynamicCacheAllocator", "Selection", "TaskProfile",
    "ExecutionPlan", "TenantModel", "TenantTask", "GemmDims", "LayerKind",
    "LayerSpec", "ModelGraph", "TrafficLedger", "CachePolicy", "CamdnPolicy",
    "StaticQuotaPolicy", "AttnPlan", "FfnPlan", "KernelPlan", "lower_ffn",
    "lower_selection",
]
