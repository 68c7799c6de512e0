// Building blocks shared by the port's hand-written Hopper kernels
// (cache_matmul.cu, block_fused_ffn.cu): conversion to the fp32 working
// type, masked tile loads from device memory into shared memory, and the
// register micro-tile FMA loop.
//
// Every kernel built from these accumulates each output element over its
// reduction axis in one fixed order, 0..K-1, in fp32 registers.  The
// result is therefore independent of the tile shape and of the launch
// order of the blocks: two launches of the same shapes are bit-identical,
// which the port's serial == pipelined serving contract relies on.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
// Round to nearest even, as JAX's and PyTorch's casts to bfloat16 do.
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Load the [R x C] tile at (r0, c0) of a row-major matrix with `rows` x
// `cols` valid elements and row stride `ld` into shared memory as fp32,
// zero outside the matrix (the ragged edges are masked here rather than
// padded through device memory).  Consecutive threads read consecutive
// columns, so a warp's loads coalesce.  With TRANSPOSE the tile lands
// column-major, dst[c * dst_ld + r]; else row-major, dst[r * dst_ld + c].
// The loop count is a compile-time constant so that it unrolls fully and
// every thread has all of its loads in flight at once.
template <typename T, int R, int C, int NT, bool TRANSPOSE>
__device__ __forceinline__ void load_tile(float* dst, int dst_ld, const T* __restrict__ src,
                                          int rows, int cols, int ld, int r0, int c0) {
  constexpr int ITERS = (R * C + NT - 1) / NT;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = it * NT + threadIdx.x;
    if ((R * C) % NT == 0 || i < R * C) {
      const int r = i / C, c = i % C;
      const int gr = r0 + r, gc = c0 + c;
      const float v = (gr < rows && gc < cols) ? to_f32(src[(size_t)gr * ld + gc]) : 0.f;
      if (TRANSPOSE) {
        dst[c * dst_ld + r] = v;
      } else {
        dst[r * dst_ld + c] = v;
      }
    }
  }
}

// acc[i][j] += sum over kk < K_TILE of As[kk][row_i] * Bs[kk][col_j], for
// the thread's rows ty + i * (BM / TM) and columns tx + j * (BN / TN).
// The rows and columns are strided so that neighbouring threads read
// neighbouring shared-memory words (no bank conflicts on Bs; a warp
// shares its As word, which is a broadcast).
template <int BM, int BN, int TM, int TN, int K_TILE>
__device__ __forceinline__ void fma_tile(float (&acc)[TM][TN], const float* As, int a_ld,
                                         const float* Bs, int b_ld, int ty, int tx) {
#pragma unroll 8
  for (int kk = 0; kk < K_TILE; ++kk) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = As[kk * a_ld + ty + i * (BM / TM)];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = Bs[kk * b_ld + tx + j * (BN / TN)];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// Dynamic shared memory above 48 KB needs the per-kernel opt-in; asking
// for it below that is harmless.
template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace repro
