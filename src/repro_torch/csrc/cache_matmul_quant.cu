// cache_matmul_quant for Hopper (sm_90a): C[M,N] = A[M,K] @ dequant(B[K,N]),
// row-major, with B stored as 1-byte codes (int8 or float8_e4m3) and one
// fp32 scale per output column, scale[1,N]; fp32 accumulation, C in A's
// type (fp32 or bf16).
//
// Replaces the Pallas TPU kernel src/repro/kernels/cache_matmul.py::
// cache_matmul_quant (body _matmul_quant_kernel), the dequant-fused LWM
// matmul behind ops.planned_matmul_quant / planned_ffn_quant.  Its
// contract is kept: B streams from device memory at quantized width and is
// dequantized on chip, so no fp copy of B ever reaches device memory.
// Here each code is read at 1 byte, converted to fp32 and multiplied by
// its column's scale with one round-to-nearest multiply (__fmul_rn: the
// product q.float() * s of the plain version) as it lands in shared
// memory; the block's [BN] scale stripe is read once, before the K loop.
//
// The layout is cache_matmul.cu's: one thread block per [BM x BN] output
// tile, the K loop inside the block (the TPU's sequential K grid axis),
// fp32 accumulators in registers (TM x TN per thread), ragged M/N/K edges
// masked in the kernel where the TPU path pads through HBM (_pad_to).
//
// Bound on the H100: at the decode shapes of a full-width yi-9b FFN (M = 2,
// K x N = 4096 x 11008 and 11008 x 4096) the kernel does 2 FLOP per
// 1-byte weight it reads: bound by the bytes of B, half of cache_matmul's
// bf16 bytes.  At prefill-sized M (2048 rows) it is bound by operations.
// This first kernel uses plain FMA from shared memory and one-byte loads;
// tensor cores (fp8 / int8 wgmma), TMA rings and a GEMV-shaped decode tile
// are later work.
//
// Plain C interface for ctypes: each entry point returns the CUDA error of
// the launch (0 on success); `tile` indexes the menu below, which the
// Python wrapper (kernels/cache_matmul.py::QUANT_TILES) mirrors and checks
// through cache_matmul_quant_tile().
#include <cuda_fp8.h>
#include <stdint.h>

#include "tile_common.cuh"

namespace repro {

__device__ __forceinline__ float code_to_f32(int8_t q) { return static_cast<float>(q); }
__device__ __forceinline__ float code_to_f32(__nv_fp8_e4m3 q) { return static_cast<float>(q); }

// Load the [BK x BN] code tile of B at (k0, n0) into shared memory as
// dequantized fp32, row-major, zero outside the matrix.  Consecutive
// threads read consecutive codes.  `sc` is the block's scale stripe.
template <typename Q, int BK, int BN, int NT>
__device__ __forceinline__ void load_codes(float* Bs, const Q* __restrict__ B,
                                           const float* sc, int K, int N, int k0,
                                           int n0) {
  constexpr int ITERS = (BK * BN + NT - 1) / NT;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = it * NT + threadIdx.x;
    if ((BK * BN) % NT == 0 || i < BK * BN) {
      const int r = i / BN, c = i % BN;
      const int gr = k0 + r, gc = n0 + c;
      Bs[r * BN + c] = (gr < K && gc < N)
                           ? __fmul_rn(code_to_f32(B[(size_t)gr * N + gc]), sc[c])
                           : 0.f;
    }
  }
}

template <typename T, typename Q, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    cache_matmul_quant_kernel(const T* __restrict__ A, const Q* __restrict__ B,
                              const float* __restrict__ scale, T* __restrict__ C,
                              int M, int N, int K) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int A_LD = BM + 1;  // padded: the transposed tile store is conflict-free
  extern __shared__ float smem[];
  float* As = smem;              // [BK][BM + 1]: A tile, k-major
  float* Bs = As + BK * A_LD;    // [BK][BN]: B tile, dequantized
  float* Ss = Bs + BK * BN;      // [BN]: the block's column scales
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  for (int c = threadIdx.x; c < BN; c += NT) Ss[c] = (n0 + c < N) ? scale[n0 + c] : 0.f;
  __syncthreads();

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<T, BM, BK, NT, true>(As, A_LD, A, M, K, K, m0, k0);
    load_codes<Q, BK, BN, NT>(Bs, B, Ss, K, N, k0, n0);
    __syncthreads();
    fma_tile<BM, BN, TM, TN, BK>(acc, As, A_LD, Bs, BN, ty, tx);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty + i * (BM / TM);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx + j * (BN / TN);
      if (r < M && c < N) C[(size_t)r * N + c] = from_f32<T>(acc[i][j]);
    }
  }
}

// One menu entry.  Shared memory: the A tile and the dequantized B tile
// staged as fp32, and the scale stripe (kernels/cache_matmul.py::QuantTile
// .smem_bytes computes the same).
template <int BM, int BN, int BK, int TM, int TN>
struct QTile {
  static constexpr int bm = BM, bn = BN, bk = BK, tm = TM, tn = TN;
  static constexpr int threads = (BM / TM) * (BN / TN);
  static constexpr int smem = (int)sizeof(float) * (BK * (BM + 1) + BK * BN + BN);
};

template <typename T, typename Q, typename TL>
cudaError_t run(const T* a, const Q* b, const float* s, T* c, int M, int N, int K,
                cudaStream_t st) {
  auto kernel = cache_matmul_quant_kernel<T, Q, TL::bm, TL::bn, TL::bk, TL::tm, TL::tn>;
  cudaError_t e = set_smem(kernel, TL::smem);
  if (e != cudaSuccess) return e;
  dim3 grid((N + TL::bn - 1) / TL::bn, (M + TL::bm - 1) / TL::bm);
  kernel<<<grid, TL::threads, TL::smem, st>>>(a, b, s, c, M, N, K);
  return cudaGetLastError();
}

// The compiled tile menu, by index (kernels/cache_matmul.py::QUANT_TILES).
using Q0 = QTile<8, 32, 256, 1, 1>;     // decode: M <= 8, weight streaming
using Q1 = QTile<16, 64, 64, 2, 2>;
using Q2 = QTile<32, 64, 64, 2, 4>;
using Q3 = QTile<64, 64, 32, 4, 4>;
using Q4 = QTile<128, 128, 32, 8, 8>;   // prefill-sized M
using Q5 = QTile<8, 32, 32, 1, 1>;      // floor: fits any plan bound

template <typename T, typename Q>
int dispatch(int tile, const void* a, const void* b, const void* s, void* c, int M, int N,
             int K, void* stream) {
  const T* A = static_cast<const T*>(a);
  const Q* B = static_cast<const Q*>(b);
  const float* S = static_cast<const float*>(s);
  T* C = static_cast<T*>(c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: return run<T, Q, Q0>(A, B, S, C, M, N, K, st);
    case 1: return run<T, Q, Q1>(A, B, S, C, M, N, K, st);
    case 2: return run<T, Q, Q2>(A, B, S, C, M, N, K, st);
    case 3: return run<T, Q, Q3>(A, B, S, C, M, N, K, st);
    case 4: return run<T, Q, Q4>(A, B, S, C, M, N, K, st);
    case 5: return run<T, Q, Q5>(A, B, S, C, M, N, K, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TL>
void describe(int* out) {
  out[0] = TL::bm; out[1] = TL::bn; out[2] = TL::bk;
  out[3] = TL::tm; out[4] = TL::tn; out[5] = TL::smem;
}

}  // namespace repro

extern "C" {

int cache_matmul_quant_f32_i8(const void* a, const void* b, const void* s, void* c, int M,
                              int N, int K, int tile, void* stream) {
  return repro::dispatch<float, int8_t>(tile, a, b, s, c, M, N, K, stream);
}

int cache_matmul_quant_f32_f8(const void* a, const void* b, const void* s, void* c, int M,
                              int N, int K, int tile, void* stream) {
  return repro::dispatch<float, __nv_fp8_e4m3>(tile, a, b, s, c, M, N, K, stream);
}

int cache_matmul_quant_bf16_i8(const void* a, const void* b, const void* s, void* c, int M,
                               int N, int K, int tile, void* stream) {
  return repro::dispatch<__nv_bfloat16, int8_t>(tile, a, b, s, c, M, N, K, stream);
}

int cache_matmul_quant_bf16_f8(const void* a, const void* b, const void* s, void* c, int M,
                               int N, int K, int tile, void* stream) {
  return repro::dispatch<__nv_bfloat16, __nv_fp8_e4m3>(tile, a, b, s, c, M, N, K, stream);
}

// Writes (bm, bn, bk, tm, tn, shared-memory bytes) of menu entry `tile`;
// returns the number of entries.
int cache_matmul_quant_tile(int tile, int* out) {
  switch (tile) {
    case 0: repro::describe<repro::Q0>(out); break;
    case 1: repro::describe<repro::Q1>(out); break;
    case 2: repro::describe<repro::Q2>(out); break;
    case 3: repro::describe<repro::Q3>(out); break;
    case 4: repro::describe<repro::Q4>(out); break;
    case 5: repro::describe<repro::Q5>(out); break;
    default: break;
  }
  return 6;
}

}  // extern "C"
