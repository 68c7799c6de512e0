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
//
// Three tile kinds, one menu (kTiles below; kernels/ops.py::
// legalize_matmul_quant_tile picks the kind by dtype, rows and row
// lengths, as legalize_matmul_tile does for cache_matmul):
//
//  * simt (fp32 and bf16; the first design): one [BM x BN] output tile per
//    block, each code read at 1 byte, converted to fp32 and multiplied by
//    its column's scale with one round-to-nearest multiply (__fmul_rn: the
//    product q.float() * s of the plain version) as it lands in shared
//    memory, then plain FMA from shared memory.  It runs every fp32 call,
//    so the fp32 contracts hold bit for bit as before.
//  * gemv (bf16, M <= 8; the decode shapes, M = 2, K x N = 4096 x 11008 and
//    11008 x 4096).  Bound by the bytes of B (45 MB, 0.0135 ms at
//    3.35 TB/s) at 2 FLOP per code; the first design was bound by the
//    instructions it spent per code (a byte load, a convert, a scale
//    multiply, a shared-memory round trip).  Here each lane loads 16 codes
//    of one row as one 16-byte vector straight into registers (a warp: two
//    rows of 256 columns), QGEMV_U loads in flight, converts them in
//    registers (int8: a byte permute into the mantissa of 2^23 and one
//    subtract, exact; e4m3: cvt.rn.f16x2.e4m3x2 and a widening, exact) and
//    does M FMAs per code against A's rows, staged once per K slab in
//    shared memory.  The scale is applied once per column at the end,
//    C = s[n] * sum_k a[k] q[k, n], not once per code: the plain version's
//    sum_k a[k] (q[k, n] s[n]) differs from it only by fp32 rounding, far
//    inside the 2e-2 bf16 tolerance, and it saves a multiply per code.
//    Columns per block stay 256 (16 lanes x 16 codes, two rows a warp), so
//    the tile is no wider than the plans' narrowest tile.  K splits across
//    blocks as cache_matmul's gemv tile splits it (kernels/
//    cache_matmul.py::gemv_split): fp32 partials summed in a fixed order by
//    a second pass that also takes the scale.
//  * wgmma (bf16, M > 8; the prefill shapes, M = 2048).  Bound by
//    operations (92 GFLOP a GEMM, 0.093 ms at 989 TFLOP/s).  Both code
//    formats are exact in bf16 (|int8| <= 127 needs 7 significant bits;
//    e4m3 has a 3-bit mantissa inside bf16's exponent range), so the codes
//    are converted to bf16, multiplied in bf16 with fp32 accumulators, and
//    the column scale is applied in the epilogue.  Of the two ways to feed
//    converted codes to wgmma this takes the first: a producer warp
//    TMA-loads A as cache_matmul's wgmma tile does and the [64 x BN] code
//    tile as unswizzled UINT8 boxes (16 KB a stage, half of a bf16 B); the
//    consumer warpgroups convert the stage into the 128-byte-swizzled
//    MN-major bf16 layout that cache_matmul's B descriptor reads, then
//    issue wgmma on it.  The conversion of stage t overlaps the
//    asynchronous products of stage t - 1; the bf16 B stages are
//    triple-buffered, so a stage is rewritten only after both warpgroups
//    have finished its products (see the loop).  The other way (codes as
//    the register A operand of C^T = B^T A^T) needs the codes transposed
//    on their way from shared memory into the fragment: per-byte gathers
//    where this way does 16-byte loads and stores.  On an H100 at the
//    prefill's gate/up shape the conversion is a large share of the
//    tile's time, in its arithmetic and its shared-memory traffic alike;
//    a separate converter warpgroup, and codes fed to it from device
//    memory through registers, were both slower than converting in the
//    consumers.  TMA needs 16-byte row strides: K a multiple of 8 (A)
//    and N a multiple of 16 (codes); the legalization sends other shapes
//    to a simt tile.
//
// Each kind sums every output element in an order fixed by the shapes
// alone, so two launches of the same shapes are bit-identical (the
// serial == pipelined serving contract); the orders of the kinds differ.
//
// Plain C interface for ctypes: each entry point returns the CUDA error of
// the launch (0 on success); `tile` indexes the menu below, which the
// Python wrapper (kernels/cache_matmul.py::QUANT_TILES) mirrors and checks
// through cache_matmul_quant_tile().
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include "hopper_async.cuh"
#include "tile_common.cuh"

namespace repro {

__device__ __forceinline__ float code_to_f32(int8_t q) { return static_cast<float>(q); }
__device__ __forceinline__ float code_to_f32(__nv_fp8_e4m3 q) { return static_cast<float>(q); }

// ---------------------------------------------------------------- simt --
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

// One simt menu entry.  Shared memory: the A tile and the dequantized B
// tile staged as fp32, and the scale stripe (kernels/cache_matmul.py::
// QuantTile.smem_bytes computes the same).
template <int BM, int BN, int BK, int TM, int TN>
struct QTile {
  static constexpr int kind = 0;    // simt
  static constexpr int dtypes = 3;  // fp32 | bf16
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

// ---------------------------------------------------------- codes ------
// Four codes of one 32-bit word (byte j is column j) as exact floats.
template <typename Q>
struct Codes;

template <>
struct Codes<int8_t> {
  // q + 128 lands in the low mantissa byte of 2^23: (2^23 + q + 128) - (2^23 + 128)
  __device__ __forceinline__ static void to_f32(uint32_t w, float (&f)[4]) {
    const uint32_t x = w ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440u + j)) - 8388736.f;
  }
};

template <>
struct Codes<__nv_fp8_e4m3> {
  // cvt.rn.f16x2.e4m3x2 (exact: e4m3 lies inside fp16), then widened
  __device__ __forceinline__ static void to_f32(uint32_t w, float (&f)[4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w >> (16 * h)), __NV_E4M3);
      const float2 v = __half22float2(__half2(r));
      f[2 * h] = v.x;
      f[2 * h + 1] = v.y;
    }
  }
};

// Two exact floats as a bf16 pair by truncation (exact: each value has at
// most 8 significant bits), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

// ---------------------------------------------------------------- gemv --
constexpr int QGEMV_BN = 256;   // columns per block: 16 lanes x 16 codes
constexpr int QGEMV_BK = 256;   // K rows of A staged per slab
constexpr int QGEMV_NW = 8;     // warps per block, two K rows each per load
constexpr int QGEMV_U = 4;      // 16-byte loads in flight per thread
constexpr int QGEMV_MAX_M = 8;

// Shared memory of a gemv block with MT rows: the A slab and, after the K
// loop, the warps' partial sums share it.
constexpr int qgemv_smem(int mt) {
  return (int)sizeof(float) * (QGEMV_BK * QGEMV_MAX_M > QGEMV_NW * mt * QGEMV_BN
                                   ? QGEMV_BK * QGEMV_MAX_M
                                   : QGEMV_NW * mt * QGEMV_BN);
}

struct QGemv {
  static constexpr int kind = 1;
  static constexpr int dtypes = 2;  // bf16
  static constexpr int bm = QGEMV_MAX_M, bn = QGEMV_BN, bk = QGEMV_BK, tm = QGEMV_MAX_M,
                       tn = 16;
  static constexpr int smem = qgemv_smem(QGEMV_MAX_M);
};

// 16 codes of row k from column c on, zero past N: one 16-byte load where
// the rows are 16-byte aligned (`vec`), else masked byte loads.
__device__ __forceinline__ uint4 load_codes16(const uint8_t* __restrict__ B, int k, int c,
                                              int N, bool vec) {
  const uint8_t* p = B + (size_t)k * N + c;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (c + j < N) w[j / 4] |= (uint32_t)__ldg(p + j) << (8 * (j % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Block (x, y): columns [256 x, 256 x + 256), K rows [y kchunk, (y + 1)
// kchunk).  Lane l of a warp takes columns 16 (l % 16) .. + 15 of row
// 2 (warp + 8 i) + l / 16.  MT >= M rows of A (1, 2, 4 or 8).  With one K
// range the block writes C = s * sum; with several, its fp32 partial sum
// P[y] for gemv_quant_reduce.
template <typename Q, int MT>
__global__ void __launch_bounds__(QGEMV_NW * 32)
    gemv_quant_kernel(const __nv_bfloat16* __restrict__ A, const uint8_t* __restrict__ B,
                      const float* __restrict__ scale, __nv_bfloat16* __restrict__ C,
                      float* __restrict__ P, int M, int N, int K, int kchunk, int vec_rows) {
  extern __shared__ float smem[];  // A slab [QGEMV_BK][8] | partials [NW][MT][BN]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int half = lane / 16;
  const int nb = blockIdx.x * QGEMV_BN;
  const int c = nb + (lane % 16) * 16;
  const int kb = blockIdx.y * kchunk;
  const int ke = min(K, kb + kchunk);
  const bool vec = vec_rows != 0;
  constexpr int STEP = 2 * QGEMV_NW;  // rows per load round of the block

  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += QGEMV_BK) {
    const int kn = min(QGEMV_BK, ke - k0);
    __syncthreads();  // the previous slab is consumed
    for (int i = threadIdx.x; i < QGEMV_BK * QGEMV_MAX_M; i += QGEMV_NW * 32) {
      const int kk = i / QGEMV_MAX_M, m = i % QGEMV_MAX_M;
      smem[i] = (m < M && kk < kn) ? __bfloat162float(A[(size_t)m * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
    if (c < N) {
      for (int r0 = 2 * warp + half; r0 < kn; r0 += STEP * QGEMV_U) {
        uint4 w[QGEMV_U];
#pragma unroll
        for (int u = 0; u < QGEMV_U; ++u) {
          const int r = r0 + u * STEP;
          w[u] = r < kn ? load_codes16(B, k0 + r, c, N, vec) : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < QGEMV_U; ++u) {
          const int r = r0 + u * STEP;
          if (r < kn) {
            float f[16];
            const uint32_t ws[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float q4[4];
              Codes<Q>::to_f32(ws[i], q4);
#pragma unroll
              for (int j = 0; j < 4; ++j) f[4 * i + j] = q4[j];
            }
            const float* a = smem + r * QGEMV_MAX_M;
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const float am = a[m];
#pragma unroll
              for (int j = 0; j < 16; ++j) acc[m][j] = fmaf(am, f[j], acc[m][j]);
            }
          }
        }
      }
    }
  }

  // the two half-warps hold the same columns: lanes 0-15 take the sum
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 16);
  __syncthreads();  // the last slab is consumed: the partials reuse it
  float* red = smem;
  if (half == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 16; j += 4)
        *reinterpret_cast<float4*>(red + (warp * MT + m) * QGEMV_BN + lane * 16 + j) =
            make_float4(acc[m][j], acc[m][j + 1], acc[m][j + 2], acc[m][j + 3]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MT * QGEMV_BN; i += QGEMV_NW * 32) {
    const int m = i / QGEMV_BN, col = nb + i % QGEMV_BN;
    float s = red[i];
#pragma unroll
    for (int w = 1; w < QGEMV_NW; ++w) s += red[w * MT * QGEMV_BN + i];
    if (m < M && col < N) {
      if (gridDim.y == 1) {
        C[(size_t)m * N + col] = __float2bfloat16_rn(__fmul_rn(scale[col], s));
      } else {
        P[((size_t)blockIdx.y * M + m) * N + col] = s;
      }
    }
  }
}

// C = bf16(s[n] * (P[0] + P[1] + ... + P[splits - 1])), in that order.
__global__ void gemv_quant_reduce(const float* __restrict__ P, const float* __restrict__ scale,
                                  __nv_bfloat16* __restrict__ C, int N, int mn, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = P[i];
  for (int k = 1; k < splits; ++k) s += P[(size_t)k * mn + i];
  C[i] = __float2bfloat16_rn(__fmul_rn(scale[i % N], s));
}

template <typename Q, int MT>
cudaError_t run_gemv_mt(const __nv_bfloat16* a, const uint8_t* b, const float* sc,
                        __nv_bfloat16* c, float* partial, int M, int N, int K, int kchunk,
                        cudaStream_t s) {
  auto kernel = gemv_quant_kernel<Q, MT>;
  cudaError_t e = set_smem(kernel, QGemv::smem);
  if (e != cudaSuccess) return e;
  const int splits = K > 0 ? (K + kchunk - 1) / kchunk : 1;
  if (splits > 1 && partial == nullptr) return cudaErrorInvalidValue;
  const int vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  dim3 grid((N + QGEMV_BN - 1) / QGEMV_BN, splits);
  kernel<<<grid, QGEMV_NW * 32, qgemv_smem(MT), s>>>(a, b, sc, c, partial, M, N, K, kchunk,
                                                     vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const int mn = M * N;
  gemv_quant_reduce<<<(mn + 255) / 256, 256, 0, s>>>(partial, sc, c, N, mn, splits);
  return cudaGetLastError();
}

template <typename Q>
cudaError_t run_gemv(const __nv_bfloat16* a, const uint8_t* b, const float* sc,
                     __nv_bfloat16* c, float* partial, int M, int N, int K, int kchunk,
                     cudaStream_t s) {
  if (kchunk <= 0) return cudaErrorInvalidValue;
  if (M <= 1) return run_gemv_mt<Q, 1>(a, b, sc, c, partial, M, N, K, kchunk, s);
  if (M <= 2) return run_gemv_mt<Q, 2>(a, b, sc, c, partial, M, N, K, kchunk, s);
  if (M <= 4) return run_gemv_mt<Q, 4>(a, b, sc, c, partial, M, N, K, kchunk, s);
  if (M <= QGEMV_MAX_M) return run_gemv_mt<Q, 8>(a, b, sc, c, partial, M, N, K, kchunk, s);
  return cudaErrorInvalidValue;
}

// --------------------------------------------------------------- wgmma --
template <int BM, int BN>
struct QWgmma {
  static constexpr int kind = 2;
  static constexpr int dtypes = 2;  // bf16
  static constexpr int bm = BM, bn = BN, bk = 64, tm = 64, tn = BN;
  static constexpr int stages = 4;                     // TMA ring of A and code tiles
  static constexpr int b_stages = 3;                   // converted bf16 B tiles
  static constexpr int consumers = BM / 64;            // warpgroups of 64 rows
  static constexpr int threads = 128 * consumers + 32;  // + one producer warp
  static constexpr int a_bytes = BM * 64 * 2;          // [BM][64] bf16, K-major
  static constexpr int q_bytes = 64 * BN;              // [64 k][BN n] codes, unswizzled
  static constexpr int b_bytes = 64 * BN * 2;          // BN / 64 boxes of [64 k][64 n] bf16
  // 1024 bytes to align to the swizzle atom, the ring, the bf16 B tiles,
  // and a full and an empty barrier per stage
  static constexpr int smem =
      1024 + stages * (a_bytes + q_bytes) + b_stages * b_bytes + 2 * stages * 8;
};

template <typename Q, typename TL>
__global__ void __launch_bounds__(TL::threads, 1)
    wgmma_quant_kernel(const __grid_constant__ CUtensorMap tmap_a,
                       const __grid_constant__ CUtensorMap tmap_q,
                       const float* __restrict__ scale, __nv_bfloat16* __restrict__ C, int M,
                       int N, int K) {
  constexpr int BM = TL::bm, BN = TL::bn, BK = TL::bk, ST = TL::stages;
  constexpr int CT = 128 * TL::consumers;  // consumer threads
  constexpr int IT = BK * BN / 16 / CT;    // 16-code vectors a thread converts a step
  static_assert(BN == 256, "one wgmma m64n256k16 per K step of 16");
  static_assert((BK * BN / 16) % CT == 0, "16-code groups split evenly");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* As = ring;
  uint8_t* Qs = As + ST * TL::a_bytes;
  uint8_t* Bs = Qs + ST * TL::q_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + TL::b_stages * TL::b_bytes);
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
        mbar_expect_tx(&full[s], TL::a_bytes + TL::q_bytes);
        tma_load_2d(As + s * TL::a_bytes, &tmap_a, &full[s], t * BK, m0);
        tma_load_2d(Qs + s * TL::q_bytes, &tmap_q, &full[s], n0, t * BK);
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
    // Convert the code tile into bf16 B tile t % 3, MN-major and 128-byte
    // swizzled as TMA would have written it: in 64-column box j, K row k
    // at 128 k bytes, its 16-byte chunk c stored at chunk c ^ (k % 8).
    // The products of tile t - 3 read this buffer last: this warpgroup
    // waited for its own at step t - 2 (wgmma_wait<1>), and the other
    // warpgroup had waited for its own before it reached the barrier of
    // step t - 1, which this one has passed.  All of a thread's code
    // vectors are loaded before any store, so the loads overlap (the
    // compiler cannot move a shared-memory load above a store it may
    // alias).
    const uint8_t* q = Qs + s * TL::q_bytes;
    uint8_t* b = Bs + (t % TL::b_stages) * TL::b_bytes;
    uint4 v[IT];
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int i = it * CT + threadIdx.x;
      v[it] = *reinterpret_cast<const uint4*>(q + (i / (BN / 16)) * BN + 16 * (i % (BN / 16)));
    }
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int i = it * CT + threadIdx.x;
      const int k = i / (BN / 16), g = i % (BN / 16);  // 16 codes: columns 16 g ..
      const uint32_t ws[4] = {v[it].x, v[it].y, v[it].z, v[it].w};
      uint32_t p[8];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        float f[4];
        Codes<Q>::to_f32(ws[w], f);
        p[2 * w] = pack_bf16_exact(f[0], f[1]);
        p[2 * w + 1] = pack_bf16_exact(f[2], f[3]);
      }
      uint8_t* row = b + (g / 4) * (BK * 128) + k * 128;
      const int c0 = 2 * (g % 4);
      *reinterpret_cast<uint4*>(row + ((c0 ^ (k % 8)) * 16)) = make_uint4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<uint4*>(row + (((c0 + 1) ^ (k % 8)) * 16)) =
          make_uint4(p[4], p[5], p[6], p[7]);
    }
    // the writes, made visible to wgmma (the async proxy) and complete in
    // both consumer warpgroups before either issues its products
    fence_proxy_async();
    named_bar_sync(1, CT);

    const uint8_t* a = As + s * TL::a_bytes + wg * 64 * 128;
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
    if (col >= N) continue;  // N % 16 == 0: col + 1 < N as well
    const float2 sc = __ldg(reinterpret_cast<const float2*>(scale + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row < M)
        *reinterpret_cast<__nv_bfloat162*>(C + (size_t)row * N + col) = __floats2bfloat162_rn(
            __fmul_rn(sc.x, acc[4 * j + 2 * h]), __fmul_rn(sc.y, acc[4 * j + 2 * h + 1]));
    }
  }
}

template <typename Q, typename TL>
cudaError_t run_wgmma(const __nv_bfloat16* a, const uint8_t* b, const float* sc,
                      __nv_bfloat16* c, int M, int N, int K, cudaStream_t s) {
  // TMA: 16-byte aligned bases and row strides; the float2 scale loads
  if (K % 8 || N % 16 || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 || reinterpret_cast<uintptr_t>(sc) % 8)
    return cudaErrorInvalidValue;
  CUtensorMap ta, tq;
  const uint64_t a_dims[2] = {(uint64_t)K, (uint64_t)M}, a_strides[1] = {(uint64_t)K * 2};
  const uint32_t a_box[2] = {64, (uint32_t)TL::bm};
  const uint64_t q_dims[2] = {(uint64_t)N, (uint64_t)K}, q_strides[1] = {(uint64_t)N};
  const uint32_t q_box[2] = {(uint32_t)TL::bn, (uint32_t)TL::bk};
  cudaError_t e = encode_tmap_bf16(&ta, a, 2, a_dims, a_strides, a_box);
  if (e != cudaSuccess) return e;
  e = encode_tmap(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, CU_TENSOR_MAP_SWIZZLE_NONE, b, 2, q_dims,
                  q_strides, q_box);
  if (e != cudaSuccess) return e;
  auto kernel = wgmma_quant_kernel<Q, TL>;
  e = set_smem(kernel, TL::smem);
  if (e != cudaSuccess) return e;
  dim3 grid((M + TL::bm - 1) / TL::bm, (N + TL::bn - 1) / TL::bn);
  kernel<<<grid, TL::threads, TL::smem, s>>>(ta, tq, sc, c, M, N, K);
  return cudaGetLastError();
}

// The compiled tile menu, by index (kernels/cache_matmul.py::QUANT_TILES).
using Q0 = QTile<8, 32, 256, 1, 1>;     // decode: M <= 8, weight streaming
using Q1 = QTile<16, 64, 64, 2, 2>;
using Q2 = QTile<32, 64, 64, 2, 4>;
using Q3 = QTile<64, 64, 32, 4, 4>;
using Q4 = QTile<128, 128, 32, 8, 8>;   // prefill-sized M
using Q5 = QTile<8, 32, 32, 1, 1>;      // floor: fits any plan bound
using Q6 = QGemv;                       // bf16 decode, M <= 8
using Q7 = QWgmma<64, 256>;             // bf16, 9 to 64 rows
using Q8 = QWgmma<128, 256>;            // bf16, more rows

template <typename T, typename Q>
int dispatch_simt(int tile, const T* A, const Q* B, const float* S, T* C, int M, int N, int K,
                  cudaStream_t st) {
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

template <typename Q>
int dispatch_bf16(int tile, const void* a, const void* b, const void* s, void* c,
                  void* partial, int M, int N, int K, int kchunk, void* stream) {
  using bf16 = __nv_bfloat16;
  const bf16* A = static_cast<const bf16*>(a);
  const float* S = static_cast<const float*>(s);
  bf16* C = static_cast<bf16*>(c);
  const uint8_t* B8 = static_cast<const uint8_t*>(b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 6: return run_gemv<Q>(A, B8, S, C, static_cast<float*>(partial), M, N, K, kchunk, st);
    case 7: return run_wgmma<Q, Q7>(A, B8, S, C, M, N, K, st);
    case 8: return run_wgmma<Q, Q8>(A, B8, S, C, M, N, K, st);
    default: return dispatch_simt<bf16, Q>(tile, A, static_cast<const Q*>(b), S, C, M, N, K, st);
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
int cache_matmul_quant_f32_i8(const void* a, const void* b, const void* s, void* c, int M,
                              int N, int K, int tile, void* stream) {
  return repro::dispatch_simt<float, int8_t>(
      tile, static_cast<const float*>(a), static_cast<const int8_t*>(b),
      static_cast<const float*>(s), static_cast<float*>(c), M, N, K,
      static_cast<cudaStream_t>(stream));
}

int cache_matmul_quant_f32_f8(const void* a, const void* b, const void* s, void* c, int M,
                              int N, int K, int tile, void* stream) {
  return repro::dispatch_simt<float, __nv_fp8_e4m3>(
      tile, static_cast<const float*>(a), static_cast<const __nv_fp8_e4m3*>(b),
      static_cast<const float*>(s), static_cast<float*>(c), M, N, K,
      static_cast<cudaStream_t>(stream));
}

// bf16 runs every tile.  The gemv tile splits K into ranges of `kchunk`
// rows; with more than one range, `partial` holds ranges x M x N fp32.
int cache_matmul_quant_bf16_i8(const void* a, const void* b, const void* s, void* c,
                               void* partial, int M, int N, int K, int tile, int kchunk,
                               void* stream) {
  return repro::dispatch_bf16<int8_t>(tile, a, b, s, c, partial, M, N, K, kchunk, stream);
}

int cache_matmul_quant_bf16_f8(const void* a, const void* b, const void* s, void* c,
                               void* partial, int M, int N, int K, int tile, int kchunk,
                               void* stream) {
  return repro::dispatch_bf16<__nv_fp8_e4m3>(tile, a, b, s, c, partial, M, N, K, kchunk,
                                             stream);
}

// Writes (kind, dtypes, bm, bn, bk, tm, tn, shared-memory bytes) of menu
// entry `tile` (kind 0 simt, 1 gemv, 2 wgmma; dtypes a mask, 1 fp32,
// 2 bf16); returns the number of entries.
int cache_matmul_quant_tile(int tile, int* out) {
  switch (tile) {
    case 0: repro::describe<repro::Q0>(out); break;
    case 1: repro::describe<repro::Q1>(out); break;
    case 2: repro::describe<repro::Q2>(out); break;
    case 3: repro::describe<repro::Q3>(out); break;
    case 4: repro::describe<repro::Q4>(out); break;
    case 5: repro::describe<repro::Q5>(out); break;
    case 6: repro::describe<repro::Q6>(out); break;
    case 7: repro::describe<repro::Q7>(out); break;
    case 8: repro::describe<repro::Q8>(out); break;
    default: break;
  }
  return 9;
}

}  // extern "C"
