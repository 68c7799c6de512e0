# Verbatim copy of examples/quickstart.py (lines 1-72: the quickstart; fc
# :17, main :23); only the package name in its imports differs. Run it as
# `python -m repro_torch.examples.quickstart`. It imports no framework.
"""Quickstart: CaMDN in 60 lines.

1. Describe a model as a layer graph.
2. Offline: build the cache-aware mapping (MCTs with LWM candidates per
   usage level + LBM per block)  — paper Sec. III-C.
3. Online: run two tenants against the shared cache with Algorithm 1
   deciding allocations — paper Sec. III-D.
4. Compare DRAM traffic against a no-cache (stream-everything) run.

  PYTHONPATH=src python examples/quickstart.py
"""
from repro_torch.core import (CacheConfig, DynamicCacheAllocator, GemmDims,
                              LayerKind, LayerSpec, ModelGraph, Nec, SharedCache,
                              TenantModel, TenantTask)


def fc(name, m, k, n):
    return LayerSpec(name, LayerKind.GEMM, (GemmDims(m, n, k),),
                     input_bytes=m * k, output_bytes=m * n,
                     weight_bytes=k * n)


def main():
    # 1) two small MLP-ish models
    g1 = ModelGraph("mlp-a", [fc("l0", 512, 1024, 1024),
                              fc("l1", 512, 1024, 1024),
                              fc("l2", 512, 1024, 4096)])
    g2 = ModelGraph("mlp-b", [fc("l0", 256, 2048, 2048),
                              fc("l1", 256, 2048, 512)])

    # 2) offline cache-aware mapping
    m1, m2 = TenantModel(g1), TenantModel(g2)
    for tm in (m1, m2):
        print(f"{tm.graph.name}: blocks={tm.mapping.blocks}")
        for mct in tm.mapping.mcts:
            lwms = [(c.p_need, c.dram_bytes // 1024) for c in mct.lwms]
            lbm = (mct.lbm.p_need, mct.lbm.dram_bytes // 1024) if mct.lbm else None
            print(f"  {mct.layer_name}: LWM(pages,KB)={lwms} LBM={lbm}")

    # 3) online: run both tenants to completion, interleaved
    cache = SharedCache(CacheConfig())
    nec = Nec(cache)
    alloc = DynamicCacheAllocator(cache)
    tasks = [TenantTask("a", m1, cache, nec, alloc),
             TenantTask("b", m2, cache, nec, alloc)]
    now = 0.0
    while any(not t.done for t in tasks):
        for t in tasks:
            if t.done:
                continue
            sel = t.begin_layer(now)
            granted = cache.alloc(t.id, t.pages_to_request())
            if granted is None:           # wait -> timeout -> downgrade
                t.on_timeout(now)
                granted = cache.alloc(t.id, t.pages_to_request()) or []
            plan = t.start_execution(now, granted)
            now += max(plan.compute_s,
                       (plan.dram_read_bytes + plan.dram_write_bytes) / 25.6e9)
            t.end_layer(now)
    camdn_bytes = nec.traffic.dram_total

    # 4) compare against stream-everything
    stream_bytes = sum(sum(tm.stream_bytes) for tm in (m1, m2))
    print(f"\nCaMDN DRAM traffic : {camdn_bytes / 2**20:.2f} MB")
    print(f"Streaming baseline : {stream_bytes / 2**20:.2f} MB")
    print(f"Saved              : {100 * (1 - camdn_bytes / stream_bytes):.1f}%")
    print(f"Makespan           : {now * 1e3:.3f} ms, "
          f"hit rate {nec.traffic.hit_rate:.2f}")


if __name__ == "__main__":
    main()
