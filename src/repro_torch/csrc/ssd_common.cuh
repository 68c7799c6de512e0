// Pieces shared by ssd_chunk's and ssd_chunk_bwd's wgmma kinds
// (csrc/ssd_chunk.cu, csrc/ssd_chunk_bwd.cu): the tile geometry, the split
// of fp32 values into bf16 hi + lo halves, and the chunk's cum scan.  The
// backward recomputes cum with the very scan the forward ran, so it
// differentiates the L the forward used, bit for bit.
#pragma once

#include "hopper_async.cuh"

namespace repro {

constexpr int kWRows = 64;            // rows of every tile: query, key, state, position
constexpr int kWBox = kWRows * 128;   // one 128-byte-swizzled box: 64 rows of 64 bf16
constexpr int kWThreads = 128;        // one warpgroup a block

// Two fp32 values as bf16 pairs hi = bf16(v) and lo = bf16(v - hi)
// (v - hi is exact in fp32), element a in the low halves.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(__fsub_rn(a, hf.x), __fsub_rn(b, hf.y));
}

// cum[q] = sum over r <= q of -dt[r] * a, by warp 0 in a fixed order:
// lane l sums its run of ceil(Q / 32) positions, a shuffle scan adds the
// runs before it, then the lane writes its run's prefix sums from there.
__device__ __forceinline__ void chunk_cum_scan(float* cum, const float* dt, float a, int Q) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int per = (Q + 31) / 32;
  const int lo = min(Q, lane * per), hi = min(Q, lo + per);
  float run = 0.f;
  for (int q = lo; q < hi; ++q) run = __fadd_rn(run, __fmul_rn(-dt[q], a));
  float inc = run;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float up = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc = __fadd_rn(up, inc);
  }
  float acc = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) acc = 0.f;
  for (int q = lo; q < hi; ++q) {
    acc = __fadd_rn(acc, __fmul_rn(-dt[q], a));
    cum[q] = acc;
  }
}

}  // namespace repro
