// cache_matmul for Hopper (sm_90a): C[M,N] = A[M,K] @ B[K,N], row-major,
// fp32 accumulation, C in A's type (fp32 or bf16).
//
// Replaces the Pallas TPU kernel src/repro/kernels/cache_matmul.py::
// cache_matmul (body _matmul_kernel), the LWM mapping candidate of the
// CaMDN serving path.  On the TPU the K axis is the sequential innermost
// grid axis and the fp32 accumulator tile lives in VMEM scratch across
// grid steps.  Blocks on a GPU run in no order, so here a thread block
// loops over K itself (all of it, or one of a few fixed K ranges whose
// sums a second pass adds in order); the fp32 accumulator stays in
// registers and is cast to A's type once, at the end, as the TPU kernel
// casts at its last K step.
//
// Three tile kinds, one menu (kTiles below; kernels/ops.py::
// legalize_matmul_tile picks the kind by dtype and rows):
//
//  * simt (fp32 and bf16; the original design): one [BM x BN] output tile
//    per block, A and B staged in shared memory as fp32, a TM x TN FMA
//    register tile per thread, K summed 0..K-1 in order.  It runs every
//    fp32 call (IEEE fp32, no TF32) and bf16 shapes the others cannot take.
//  * gemv (bf16, M <= 8; the decode shapes, M = 2, K x N = 4096 x 11008 and
//    11008 x 4096).  Bound by the bytes of B (90 MB, 0.027 ms at
//    3.35 TB/s) at 2 FLOP per weight element.  Each thread streams 16-byte
//    vectors of B (8 columns of one row) from device memory straight into
//    registers, GEMV_U rows in flight, converts them in pairs and does M
//    FMAs per weight element against A's rows, staged once per K slab in
//    shared memory as fp32.  A block covers 256 columns; its 8 warps split
//    the block's K range row by row, and blocks split K further where the
//    columns alone give too few blocks (the wrapper's `kchunk`).  Partial
//    sums meet in a fixed order: warps in shared memory, K splits in a
//    second small pass over fp32 partials.  No atomics: two launches of
//    the same shapes are bit-identical.
//  * wgmma (bf16, M > 8; the prefill shapes, M = 2048).  Bound by
//    operations (184.7 GFLOP for the two FFN GEMMs, 0.187 ms at 989
//    TFLOP/s).  A [BM x BN] block tile, K in steps of 64: one producer warp
//    keeps a 4-stage ring of A and B tiles filled by TMA (128-byte
//    swizzled, mbarrier per stage, zero fill past the edges); BM / 64
//    consumer warpgroups issue wgmma m64nBNk16 with fp32 accumulators in
//    registers, one K step in flight while the next is issued.  B is
//    [K, N] row-major, MN-major for wgmma: the transpose bit and an MN-major
//    descriptor read it as it lies.  The accumulators round to bf16 once.
//    Blocks walk M fastest, so a wave of blocks covers whole columns of
//    output tiles: each B tile crosses device memory about once while A
//    stays in L2 (on an H100 at the prefill shapes, 12-15% faster than N
//    fastest; a 128 x 128 tile was slower either way).
//    TMA needs 16-byte row strides, so K and N are multiples of 8 here;
//    the legalization sends other shapes to a simt tile.
//
// Each kind sums every output element in an order fixed by the shapes
// alone, so two launches of the same shapes are bit-identical (the
// serial == pipelined serving contract); the orders of the kinds differ.
//
// Plain C interface for ctypes: each entry point returns the CUDA error
// of the launch (0 on success); `tile` indexes kTiles below, which the
// Python wrapper (kernels/cache_matmul.py::TILES) mirrors and checks
// through cache_matmul_tile().
#include "hopper_async.cuh"
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
  static constexpr int kind = 0;  // simt
  static constexpr int dtypes = 3;  // fp32 | bf16
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

// ---------------------------------------------------------------- gemv --
constexpr int GEMV_BN = 256;  // columns per block: 32 lanes x 8
constexpr int GEMV_BK = 256;  // K rows of A staged per slab
constexpr int GEMV_NW = 8;    // warps per block, splitting the K rows
constexpr int GEMV_U = 4;     // rows of B in flight per thread
constexpr int GEMV_MAX_M = 8;

// Shared memory of a gemv block with MT rows: the A slab and, after the K
// loop, the warps' partial sums share it.
constexpr int gemv_smem(int mt) {
  return (int)sizeof(float) * (GEMV_BK * GEMV_MAX_M > GEMV_NW * mt * GEMV_BN
                                   ? GEMV_BK * GEMV_MAX_M
                                   : GEMV_NW * mt * GEMV_BN);
}

struct Gemv {
  static constexpr int kind = 1;
  static constexpr int dtypes = 2;  // bf16
  static constexpr int bm = GEMV_MAX_M, bn = GEMV_BN, bk = GEMV_BK, tm = GEMV_MAX_M, tn = 8;
  static constexpr int smem = gemv_smem(GEMV_MAX_M);
};

// 8 bf16 of row k from column c on, zero past N: one 16-byte load where
// the rows are 16-byte aligned (`vec`), else masked 2-byte loads.
__device__ __forceinline__ uint4 load_row8(const __nv_bfloat16* __restrict__ B, int k, int c,
                                           int N, bool vec) {
  const __nv_bfloat16* p = B + (size_t)k * N + c;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (c + j < N)
      w[j / 2] |= (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p) + j) << (16 * (j % 2));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// bf16 -> fp32 is a 16-bit shift, two values per 32-bit word.
__device__ __forceinline__ void bf16x8_to_f32(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Block (x, y): columns [256 x, 256 x + 256), K rows [y kchunk, (y + 1)
// kchunk).  MT >= M rows of A (1, 2, 4 or 8).  With one K range the block
// writes C; with several it writes its fp32 partial P[y] for gemv_reduce.
template <int MT>
__global__ void __launch_bounds__(GEMV_NW * 32)
    gemv_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
                __nv_bfloat16* __restrict__ C, float* __restrict__ P, int M, int N, int K,
                int kchunk, int vec_rows) {
  extern __shared__ float smem[];  // A slab [GEMV_BK][8] | partials [NW][MT][BN]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nb = blockIdx.x * GEMV_BN;
  const int c = nb + lane * 8;
  const int kb = blockIdx.y * kchunk;
  const int ke = min(K, kb + kchunk);
  const bool vec = vec_rows != 0;

  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += GEMV_BK) {
    const int kn = min(GEMV_BK, ke - k0);
    __syncthreads();  // the previous slab is consumed
    for (int i = threadIdx.x; i < GEMV_BK * GEMV_MAX_M; i += GEMV_NW * 32) {
      const int kk = i / GEMV_MAX_M, m = i % GEMV_MAX_M;
      smem[i] = (m < M && kk < kn) ? __bfloat162float(A[(size_t)m * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
    if (c < N) {
      for (int r0 = warp; r0 < kn; r0 += GEMV_NW * GEMV_U) {
        uint4 w[GEMV_U];
#pragma unroll
        for (int u = 0; u < GEMV_U; ++u) {
          const int r = r0 + u * GEMV_NW;
          w[u] = r < kn ? load_row8(B, k0 + r, c, N, vec) : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < GEMV_U; ++u) {
          const int r = r0 + u * GEMV_NW;
          if (r < kn) {
            float f[8];
            bf16x8_to_f32(w[u], f);
            const float* a = smem + r * GEMV_MAX_M;
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const float am = a[m];
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(am, f[j], acc[m][j]);
            }
          }
        }
      }
    }
  }

  __syncthreads();  // the last slab is consumed: the partials reuse it
  float* red = smem;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) red[(warp * MT + m) * GEMV_BN + lane * 8 + j] = acc[m][j];
  __syncthreads();
  for (int i = threadIdx.x; i < MT * GEMV_BN; i += GEMV_NW * 32) {
    const int m = i / GEMV_BN, col = nb + i % GEMV_BN;
    float s = red[i];
#pragma unroll
    for (int w = 1; w < GEMV_NW; ++w) s += red[w * MT * GEMV_BN + i];
    if (m < M && col < N) {
      if (gridDim.y == 1) {
        C[(size_t)m * N + col] = __float2bfloat16_rn(s);
      } else {
        P[((size_t)blockIdx.y * M + m) * N + col] = s;
      }
    }
  }
}

// C = bf16(P[0] + P[1] + ... + P[splits - 1]), in that order.
__global__ void gemv_reduce(const float* __restrict__ P, __nv_bfloat16* __restrict__ C, int mn,
                            int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = P[i];
  for (int k = 1; k < splits; ++k) s += P[(size_t)k * mn + i];
  C[i] = __float2bfloat16_rn(s);
}

template <int MT>
cudaError_t run_gemv_mt(const __nv_bfloat16* a, const __nv_bfloat16* b, __nv_bfloat16* c,
                        float* partial, int M, int N, int K, int kchunk, cudaStream_t s) {
  auto kernel = gemv_kernel<MT>;
  cudaError_t e = set_smem(kernel, Gemv::smem);
  if (e != cudaSuccess) return e;
  const int splits = K > 0 ? (K + kchunk - 1) / kchunk : 1;
  if (splits > 1 && partial == nullptr) return cudaErrorInvalidValue;
  const int vec = N % 8 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  dim3 grid((N + GEMV_BN - 1) / GEMV_BN, splits);
  kernel<<<grid, GEMV_NW * 32, gemv_smem(MT), s>>>(a, b, c, partial, M, N, K, kchunk, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const int mn = M * N;
  gemv_reduce<<<(mn + 255) / 256, 256, 0, s>>>(partial, c, mn, splits);
  return cudaGetLastError();
}

cudaError_t run_gemv(const __nv_bfloat16* a, const __nv_bfloat16* b, __nv_bfloat16* c,
                     float* partial, int M, int N, int K, int kchunk, cudaStream_t s) {
  if (kchunk <= 0) return cudaErrorInvalidValue;
  if (M <= 1) return run_gemv_mt<1>(a, b, c, partial, M, N, K, kchunk, s);
  if (M <= 2) return run_gemv_mt<2>(a, b, c, partial, M, N, K, kchunk, s);
  if (M <= 4) return run_gemv_mt<4>(a, b, c, partial, M, N, K, kchunk, s);
  if (M <= GEMV_MAX_M) return run_gemv_mt<8>(a, b, c, partial, M, N, K, kchunk, s);
  return cudaErrorInvalidValue;
}

// --------------------------------------------------------------- wgmma --
template <int BM, int BN>
struct Wgmma {
  static constexpr int kind = 2;
  static constexpr int dtypes = 2;  // bf16
  static constexpr int bm = BM, bn = BN, bk = 64, tm = 64, tn = BN;
  static constexpr int stages = 4;
  static constexpr int consumers = BM / 64;            // warpgroups of 64 rows
  static constexpr int threads = 128 * consumers + 32;  // + one producer warp
  static constexpr int a_bytes = BM * 64 * 2;          // [BM][64] bf16, K-major
  static constexpr int b_bytes = 64 * BN * 2;          // BN / 64 boxes of [64 k][64 n]
  // 1024 bytes to align the ring to the swizzle atom, the ring, and a
  // full and an empty barrier per stage
  static constexpr int smem = 1024 + stages * (a_bytes + b_bytes) + 2 * stages * 8;
};

template <typename TL>
__global__ void __launch_bounds__(TL::threads, 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap tmap_a,
                 const __grid_constant__ CUtensorMap tmap_b, __nv_bfloat16* __restrict__ C, int M,
                 int N, int K) {
  constexpr int BM = TL::bm, BN = TL::bn, BK = TL::bk, ST = TL::stages;
  static_assert(BN == 256, "one wgmma m64n256k16 per K step of 16");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* As = ring;
  uint8_t* Bs = ring + ST * TL::a_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + ST * TL::b_bytes);
  uint64_t* empty = full + ST;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;  // M fastest
  const int kt = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], TL::consumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == TL::consumers) {  // the producer warp
    if (tid == 0) {
      for (int t = 0; t < kt; ++t) {
        const int s = t % ST;
        if (t >= ST) mbar_wait(&empty[s], (t / ST - 1) & 1);
        mbar_expect_tx(&full[s], TL::a_bytes + TL::b_bytes);
        tma_load_2d(As + s * TL::a_bytes, &tmap_a, &full[s], t * BK, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(Bs + s * TL::b_bytes + j * (BK * 128), &tmap_b, &full[s], n0 + 64 * j,
                      t * BK);
      }
    }
    return;
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < kt; ++t) {
    const int s = t % ST;
    mbar_wait(&full[s], (t / ST) & 1);
    const uint8_t* a = As + s * TL::a_bytes + wg * 64 * 128;
    const uint8_t* b = Bs + s * TL::b_bytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n256k16_ss<1>(acc, desc_b128(a + 32 * kk, 16, 1024),
                             desc_b128(b + 2048 * kk, BK * 128, 1024));
    wgmma_commit();
    // the previous K step's products are done: release its stage
    wgmma_wait<1>();
    fence_regs(acc);
    if (t > 0 && tid == 0) mbar_arrive(&empty[(t - 1) % ST]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int warp = tid / 32, lane = tid % 32;
  const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= N) continue;  // N % 8 == 0: col + 1 < N as well
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row < M)
        *reinterpret_cast<__nv_bfloat162*>(C + (size_t)row * N + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

template <typename TL>
cudaError_t run_wgmma(const __nv_bfloat16* a, const __nv_bfloat16* b, __nv_bfloat16* c, int M,
                      int N, int K, cudaStream_t s) {
  // TMA: 16-byte aligned bases and row strides
  if (K % 8 || N % 8 || reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  const uint64_t a_dims[2] = {(uint64_t)K, (uint64_t)M}, a_strides[1] = {(uint64_t)K * 2};
  const uint32_t a_box[2] = {64, (uint32_t)TL::bm};
  const uint64_t b_dims[2] = {(uint64_t)N, (uint64_t)K}, b_strides[1] = {(uint64_t)N * 2};
  const uint32_t b_box[2] = {64, 64};
  cudaError_t e = encode_tmap_bf16(&ta, a, 2, a_dims, a_strides, a_box);
  if (e != cudaSuccess) return e;
  e = encode_tmap_bf16(&tb, b, 2, b_dims, b_strides, b_box);
  if (e != cudaSuccess) return e;
  auto kernel = wgmma_kernel<TL>;
  e = set_smem(kernel, TL::smem);
  if (e != cudaSuccess) return e;
  dim3 grid((M + TL::bm - 1) / TL::bm, (N + TL::bn - 1) / TL::bn);
  kernel<<<grid, TL::threads, TL::smem, s>>>(ta, tb, c, M, N, K);
  return cudaGetLastError();
}

// The compiled tile menu, by index (kernels/cache_matmul.py::TILES).
using T0 = Tile<8, 32, 256, 1, 1>;     // decode: M <= 8, weight streaming
using T1 = Tile<16, 64, 64, 2, 2>;
using T2 = Tile<32, 64, 64, 2, 4>;
using T3 = Tile<64, 64, 32, 4, 4>;
using T4 = Tile<128, 128, 32, 8, 8>;   // prefill-sized M
using T5 = Tile<8, 32, 32, 1, 1>;      // floor: fits any plan bound
using T6 = Gemv;                       // bf16 decode, M <= 8
using T7 = Wgmma<64, 256>;             // bf16, 9 to 64 rows
using T8 = Wgmma<128, 256>;            // bf16, more rows

template <typename T>
int dispatch_simt(int tile, const T* A, const T* B, T* C, int M, int N, int K, cudaStream_t s) {
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
  out[0] = TL::kind; out[1] = TL::dtypes;
  out[2] = TL::bm; out[3] = TL::bn; out[4] = TL::bk;
  out[5] = TL::tm; out[6] = TL::tn; out[7] = TL::smem;
}

}  // namespace repro

extern "C" {

// fp32 runs the simt tiles only.
int cache_matmul_f32(const void* a, const void* b, void* c, int M, int N, int K, int tile,
                     void* stream) {
  return repro::dispatch_simt<float>(tile, static_cast<const float*>(a),
                                     static_cast<const float*>(b), static_cast<float*>(c), M,
                                     N, K, static_cast<cudaStream_t>(stream));
}

// bf16 runs every tile.  The gemv tile splits K into ranges of `kchunk`
// rows; with more than one range, `partial` holds ranges x M x N fp32.
int cache_matmul_bf16(const void* a, const void* b, void* c, void* partial, int M, int N, int K,
                      int tile, int kchunk, void* stream) {
  using bf16 = __nv_bfloat16;
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* B = static_cast<const bf16*>(b);
  bf16* C = static_cast<bf16*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 6: return repro::run_gemv(A, B, C, static_cast<float*>(partial), M, N, K, kchunk, s);
    case 7: return repro::run_wgmma<repro::T7>(A, B, C, M, N, K, s);
    case 8: return repro::run_wgmma<repro::T8>(A, B, C, M, N, K, s);
    default: return repro::dispatch_simt<bf16>(tile, A, B, C, M, N, K, s);
  }
}

// Writes (kind, dtypes, bm, bn, bk, tm, tn, shared-memory bytes) of menu
// entry `tile` (kind 0 simt, 1 gemv, 2 wgmma; dtypes a mask, 1 fp32,
// 2 bf16); returns the number of entries.
int cache_matmul_tile(int tile, int* out) {
  switch (tile) {
    case 0: repro::describe<repro::T0>(out); break;
    case 1: repro::describe<repro::T1>(out); break;
    case 2: repro::describe<repro::T2>(out); break;
    case 3: repro::describe<repro::T3>(out); break;
    case 4: repro::describe<repro::T4>(out); break;
    case 5: repro::describe<repro::T5>(out); break;
    case 6: repro::describe<repro::T6>(out); break;
    case 7: repro::describe<repro::T7>(out); break;
    case 8: repro::describe<repro::T8>(out); break;
    default: break;
  }
  return 9;
}

}  // extern "C"
