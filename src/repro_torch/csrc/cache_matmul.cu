// cache_matmul for Hopper (sm_90a): C[M,N] = A[M,K] @ B[K,N], row-major,
// fp32 accumulation, C in A's type (fp32 or bf16).
//
// Replaces the Pallas TPU kernel src/repro/kernels/cache_matmul.py::
// cache_matmul (body _matmul_kernel), the LWM mapping candidate of the
// CaMDN serving path.  On the TPU the K axis is the sequential innermost
// grid axis and the fp32 accumulator tile lives in VMEM scratch across
// grid steps.  Blocks on a GPU run in no order, so here one thread block
// owns one [BM x BN] output tile and loops over K itself; the fp32
// accumulator stays in registers (TM x TN per thread) and is cast to A's
// type once, at the end, as the TPU kernel casts at its last K step.
//
// Bound on the H100: at the decode shapes of the serving path (M = batch,
// 2; K x N = 4096 x 11008 and 11008 x 4096 in bf16) the kernel does 2
// FLOP per weight element it reads, far below the ~295 FLOP/byte the
// card needs to be compute bound: it is bound by the bytes of B.  The
// design answers that by reading every element of B exactly once per
// M tile, masking the ragged M/N/K edges in the kernel instead of padding
// M = 2 to 128 rows through device memory (as the TPU path does), and by
// offering a skinny tile (BM = 8, BN = 32, BK = 256) that puts a 16 KB
// B tile in flight per block and spreads N over enough blocks to cover
// the card's 132 SMs.  It uses plain FMA, not tensor cores: the same code
// serves fp32 (the reduced configs) and bf16, and at decode it is not
// compute bound.  TMA / wgmma pipelining is later work.
//
// Plain C interface for ctypes: each entry point returns the CUDA error
// of the launch (0 on success); `tile` indexes kTiles below, which the
// Python wrapper (kernels/cache_matmul.py::TILES) mirrors and checks
// through cache_matmul_tile().
#include "tile_common.cuh"

namespace repro {

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    cache_matmul_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
                        int M, int N, int K) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int A_LD = BM + 1;  // padded: the transposed tile store is conflict-free
  extern __shared__ float smem[];
  float* As = smem;              // [BK][BM + 1]: A tile, k-major
  float* Bs = smem + BK * A_LD;  // [BK][BN]
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<T, BM, BK, NT, true>(As, A_LD, A, M, K, K, m0, k0);
    load_tile<T, BK, BN, NT, false>(Bs, BN, B, K, N, N, k0, n0);
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

template <int BM, int BN, int BK, int TM, int TN>
struct Tile {
  static constexpr int bm = BM, bn = BN, bk = BK, tm = TM, tn = TN;
  static constexpr int threads = (BM / TM) * (BN / TN);
  static constexpr int smem = (int)sizeof(float) * (BK * (BM + 1) + BK * BN);
};

template <typename T, typename TL>
cudaError_t run(const T* a, const T* b, T* c, int M, int N, int K, cudaStream_t s) {
  auto kernel = cache_matmul_kernel<T, TL::bm, TL::bn, TL::bk, TL::tm, TL::tn>;
  cudaError_t e = set_smem(kernel, TL::smem);
  if (e != cudaSuccess) return e;
  dim3 grid((N + TL::bn - 1) / TL::bn, (M + TL::bm - 1) / TL::bm);
  kernel<<<grid, TL::threads, TL::smem, s>>>(a, b, c, M, N, K);
  return cudaGetLastError();
}

// The compiled tile menu, by index (kernels/cache_matmul.py::TILES).
using T0 = Tile<8, 32, 256, 1, 1>;     // decode: M <= 8, weight streaming
using T1 = Tile<16, 64, 64, 2, 2>;
using T2 = Tile<32, 64, 64, 2, 4>;
using T3 = Tile<64, 64, 32, 4, 4>;
using T4 = Tile<128, 128, 32, 8, 8>;   // prefill-sized M
using T5 = Tile<8, 32, 32, 1, 1>;      // floor: fits any plan bound

template <typename T>
int dispatch(int tile, const void* a, const void* b, void* c, int M, int N, int K, void* stream) {
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  T* C = static_cast<T*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: return run<T, T0>(A, B, C, M, N, K, s);
    case 1: return run<T, T1>(A, B, C, M, N, K, s);
    case 2: return run<T, T2>(A, B, C, M, N, K, s);
    case 3: return run<T, T3>(A, B, C, M, N, K, s);
    case 4: return run<T, T4>(A, B, C, M, N, K, s);
    case 5: return run<T, T5>(A, B, C, M, N, K, s);
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

int cache_matmul_f32(const void* a, const void* b, void* c, int M, int N, int K, int tile,
                     void* stream) {
  return repro::dispatch<float>(tile, a, b, c, M, N, K, stream);
}

int cache_matmul_bf16(const void* a, const void* b, void* c, int M, int N, int K, int tile,
                      void* stream) {
  return repro::dispatch<__nv_bfloat16>(tile, a, b, c, M, N, K, stream);
}

// Writes (bm, bn, bk, tm, tn, shared-memory bytes) of menu entry `tile`;
// returns the number of entries.
int cache_matmul_tile(int tile, int* out) {
  switch (tile) {
    case 0: repro::describe<repro::T0>(out); break;
    case 1: repro::describe<repro::T1>(out); break;
    case 2: repro::describe<repro::T2>(out); break;
    case 3: repro::describe<repro::T3>(out); break;
    case 4: repro::describe<repro::T4>(out); break;
    case 5: repro::describe<repro::T5>(out); break;
    default: break;
  }
  return 6;
}

}  // extern "C"
