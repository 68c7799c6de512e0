// flash_attention for Hopper (sm_90a): causal or bidirectional GQA
// attention with an online softmax,  O = softmax(Q K^T * hd^-0.5) V,
// q [B,H,S,hd] and k, v [B,Hkv,Sk,hd], O in q's type (fp32 or bf16).
//
// Replaces two entry points of the Pallas TPU kernel
// src/repro/kernels/flash_attention.py, which share one body
// (_flash_kernel):
//   * flash_attention (:85, pallas_call at :111): K/V in q's type;
//   * flash_attention_quantized (:132, pallas_call at :173): K/V int8 or
//     float8_e4m3 with one fp32 scale per row [B,Hkv,Sk], dequantized on
//     chip.  In fp32 (and bf16 at hd 32) a template flag (QUANT) on the
//     simt kernel: each K/V tile is dequantized to fp32 as it lands in
//     shared memory; bf16 at hd 128, 112 and 64 runs the quantized wgmma
//     kernel below.  No dequantized copy ever reaches device memory.
//
// What it computes, as _flash_kernel does: fp32 scores times
// sm_scale = hd^-0.5; masked entries set to -1e30 (not -inf); an online
// softmax with fp32 running max m, running sum l and accumulator; KV
// tiles wholly above the causal diagonal skipped; O = acc / l, with
// l == 0 guarded.  Cast points are the reference's: the native kernel
// rounds p to V's type before the P.V product (p.astype(v.dtype)); the
// quantized kernel keeps p in fp32 because V is fp32 after dequant.
// The causal mask assumes q and k both start at position 0 (the
// reference's limit).  Ragged S and Sk are masked here: keys at
// positions >= Sk are masked like causal ones and rows >= S are not
// written, where the TPU path pads through device memory.
//
// GQA: q-head h reads KV head h / (H / Hkv) through its own offsets; no
// K/V is repeated in device memory.
//
// Layout (simt).  One thread block per (b*H + h, BQ-row q tile).  The q tile
// stays in shared memory as fp32; the block loops over BKV-row KV tiles,
// staging K (transposed) and V in shared memory as fp32, computes its
// [BQ x BKV] score tile in registers (TM x TN per thread), reduces row
// max and row sum across the NTX threads that share a row with warp
// shuffles, writes p to shared memory and accumulates P.V into a
// [TM x HD/NTX] register tile per thread.
//
// Determinism and the quantized contract.  Every sum runs in one fixed
// order and there are no atomics.  The softmax update uses explicitly
// rounded intrinsics (__fmul_rn, __fsub_rn, __fadd_rn), so the compiler
// cannot contract it differently in different instantiations: in fp32,
// the quantized kernel's output equals the native kernel's on the
// dequantized K/V bit for bit (the dequant is one __fmul_rn per element,
// the same product torch computes for dequantize_rows).
//
// Bound on the H100: at the prefill path's shape (B 2, H 32, Hkv 4,
// S = Sk = 1024, hd 128, causal) the work is 2*B*H*S*Sk*hd = 17 GFLOP
// against 38 MB of inputs and output: far above the card's ~295 FLOP per
// byte, so it is bound by operations (0.017 ms at the bf16 tensor-core
// peak).  Three kernels, one menu:
//
//  * simt (flash_kernel; fp32, head dim 32, and bf16 where asked; native
//    or quantized K/V): plain fp32 FMA from shared memory,
//    as described above.  K/V cross device memory once per q tile at
//    their stored width (1 byte a value when quantized), and the causal q
//    tiles are launched longest first so the tail is short.
//  * wgmma (flash_wgmma_kernel; bf16 q and native K/V at hd 128, 112 and
//    64): one block per (b*H + h, q tile of 128 rows, or at hd 64 also
//    64), longest first.  A producer warp loads the q tile once and K/V
//    tiles of 128 keys into a ring by TMA (128-byte swizzled, zero fill
//    past S and Sk, and at hd 112 past the row: its 224-byte rows land in
//    two 64-wide boxes whose last 16 columns are zeros; 2 stages at hd 128
//    and 112, 4 at hd 64, whose tiles are half the size); the consumer
//    warpgroups, one per 64 q rows, compute S = Q K^T with wgmma
//    m64n128k16 from shared memory (K's [keys, hd] tile is K-major as it
//    lies; hd / 16 k-steps: 8, 7 or 4), run the online
//    softmax on the accumulator fragment in registers (row max and sum over
//    the 4 threads of a row by shuffles, in fp32, on log2(e)-scaled scores
//    with exp2f), round p to bf16 in registers as the reference's
//    p.astype(v.dtype) does, and feed it as wgmma's register A operand for
//    O += P V (V's [keys, hd] tile is MN-major: the transpose bit; m64n128
//    at hd 128 and 112, whose 16 zero columns are not stored, m64n64 at
//    hd 64).  The -1e30 mask, the l == 0 guard and
//    the skipped tiles are the simt kernel's.  At whisper-tiny's decoder
//    prefill (B 2, H 6, S 448, hd 64) the 128-row q tiles give 48 blocks
//    for 132 SMs, the 64-row ones 96.
//  * wgmma, quantized (flash_wgmma_quant_kernel; bf16 q with int8 or e4m3
//    K/V at hd 128, 112 and 64): the wgmma kernel fed codes.  The
//    producer warp TMA-loads the q tile once and, per step, the [128 keys
//    x hd] code tiles of K and V (unswizzled; rows of hd bytes) into a
//    stage (one at hd 128, two at 112 and 64, as shared memory allows).
//    The two consumer warpgroups convert the stage to bf16
//    (exact for both formats: hopper_async.cuh's Codes) into the
//    128-byte-swizzled [keys, hd] layout the native kernel's TMA writes,
//    double-buffered, and copy the step's 128 K and 128 V row scales
//    beside it; the stage is released as soon as it is converted, so the
//    next one loads under this step's products.  The scales are folded,
//    not multiplied into the codes: the K scale is per key, a column of
//    the scores, so s = (q . code_k) * ks * hd^-0.5 on the accumulator
//    fragment, in the pass that masks (bf16 x bf16 products are exact,
//    fp32 sums: closer to the reference's fp32 dequantized K than a bf16
//    code * scale would be); the V scale is per key, a column of P, so
//    p' = p * vs is formed before the bf16 rounding the native kernel
//    already does, and O += P' codes_V, while l sums the fp32 p.  The
//    mask, the l == 0 guard and the skipped tiles are the native
//    kernel's.  No dequantized K/V reaches device memory.  Later tuning:
//    the H / Hkv q-head blocks of one GQA group convert the same K/V
//    tiles again, each for itself.
//
// Plain C interface for ctypes: the entry point returns the CUDA error
// of the launch (0 on success); `tile` indexes the menu below, which
// kernels/flash_attention.py::TILES mirrors and checks through
// flash_attention_tile().
#include <cstdint>

#include <cuda_fp8.h>

#include "hopper_async.cuh"
#include "tile_common.cuh"

namespace repro {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

template <int HD, int BQ, int BKV, int TM, int TN>
struct AttnTile {
  static constexpr int kind = 0, dtypes = 3;  // simt; fp32 | bf16
  static constexpr int kv = 3;                // native | quantized K/V
  static constexpr int hd = HD, bq = BQ, bkv = BKV, tm = TM, tn = TN;
  static constexpr int ntx = BKV / TN;      // threads sharing a q row
  static constexpr int nty = BQ / TM;
  static constexpr int threads = ntx * nty;
  static constexpr int to = HD / ntx;       // output columns per thread
  static_assert(ntx <= 32 && (ntx & (ntx - 1)) == 0, "a row's threads share a warp");
  static_assert(HD % ntx == 0, "output columns split evenly");
  // shared-memory layout, in floats
  static constexpr int q_ld = BQ + 1, k_ld = BKV + 1, p_ld = BQ + 1;
  static constexpr int q_off = 0;                  // q   [HD][BQ+1], d-major
  static constexpr int k_off = q_off + HD * q_ld;  // k   [HD][BKV+1], d-major
  static constexpr int v_off = k_off + HD * k_ld;  // v   [BKV][HD]
  static constexpr int p_off = v_off + BKV * HD;   // p   [BKV][BQ+1], key-major
  static constexpr int floats = p_off + BKV * p_ld;
  static constexpr int smem = (int)sizeof(float) * floats;
};

// Rows [r0, r0 + R) of a [rows x HD] row-major K or V slab into shared
// memory as fp32, each value times its row's scale when QUANT, zero past
// `rows`.  TRANSPOSE stores dst[c * ld + r], else dst[r * ld + c].
template <typename T, bool QUANT, int R, int HD, int NT, bool TRANSPOSE>
__device__ __forceinline__ void load_kv(float* dst, int ld, const T* __restrict__ src,
                                        const float* __restrict__ scale, int rows, int r0) {
  constexpr int ITERS = (R * HD + NT - 1) / NT;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = it * NT + threadIdx.x;
    if ((R * HD) % NT == 0 || i < R * HD) {
      const int r = i / HD, c = i % HD;
      const int gr = r0 + r;
      float v = 0.f;
      if (gr < rows) {
        v = to_f32(src[(size_t)gr * HD + c]);
        if constexpr (QUANT) v = __fmul_rn(v, scale[gr]);
      }
      if (TRANSPOSE) {
        dst[c * ld + r] = v;
      } else {
        dst[r * ld + c] = v;
      }
    }
  }
}

template <int NTX>
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = NTX / 2; off > 0; off /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int NTX>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = NTX / 2; off > 0; off /= 2) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename TQ, typename TKV, bool QUANT, typename TL>
__global__ void __launch_bounds__(TL::threads)
    flash_kernel(const TQ* __restrict__ Q, const TKV* __restrict__ K, const TKV* __restrict__ V,
                 const float* __restrict__ KS, const float* __restrict__ VS, TQ* __restrict__ O,
                 int H, int groups, int S, int Sk, int causal, float sm_scale) {
  constexpr int HD = TL::hd, BQ = TL::bq, BKV = TL::bkv, TM = TL::tm, TN = TL::tn;
  constexpr int NTX = TL::ntx, NTY = TL::nty, NT = TL::threads, TO = TL::to;
  extern __shared__ float smem[];
  float* Qs = smem + TL::q_off;
  float* Ks = smem + TL::k_off;
  float* Vs = smem + TL::v_off;
  float* Ps = smem + TL::p_off;
  const int tx = threadIdx.x % NTX;
  const int ty = threadIdx.x / NTX;
  const int bh = blockIdx.y;                         // b * H + h
  const int kvh = (bh / H) * (H / groups) + (bh % H) / groups;
  // causal: the longest q tiles first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const TQ* q = Q + (size_t)bh * S * HD;
  const TKV* k = K + (size_t)kvh * Sk * HD;
  const TKV* v = V + (size_t)kvh * Sk * HD;
  const float* ks = QUANT ? KS + (size_t)kvh * Sk : nullptr;
  const float* vs = QUANT ? VS + (size_t)kvh * Sk : nullptr;

  load_tile<TQ, BQ, HD, NT, true>(Qs, TL::q_ld, q, S, HD, HD, q0, 0);

  float m[TM], l[TM], acc[TM][TO];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TO; ++c) acc[i][c] = 0.f;
  }

  int n_kv = (Sk + BKV - 1) / BKV;
  if (causal) n_kv = min(n_kv, (min(q0 + BQ, S) - 1) / BKV + 1);
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BKV;
    load_kv<TKV, QUANT, BKV, HD, NT, true>(Ks, TL::k_ld, k, ks, Sk, k0);
    load_kv<TKV, QUANT, BKV, HD, NT, false>(Vs, HD, v, vs, Sk, k0);
    __syncthreads();

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
    fma_tile<BQ, BKV, TM, TN, HD>(s, Qs, TL::q_ld, Ks, TL::k_ld, ty, tx);

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = q0 + ty + i * NTY;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kpos = k0 + tx + j * NTX;
        float x = __fmul_rn(s[i][j], sm_scale);
        if (kpos >= Sk || (causal && kpos > qpos)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max<NTX>(mx));
      const float alpha = expf(__fsub_rn(m[i], m_new));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = expf(__fsub_rn(s[i][j], m_new));
        sum = __fadd_rn(sum, p);
        // the native kernel rounds p to V's type; the quantized one keeps fp32
        float pv = p;
        if constexpr (!QUANT) pv = to_f32(from_f32<TKV>(p));
        Ps[(tx + j * NTX) * TL::p_ld + ty + i * NTY] = pv;
      }
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha), row_sum<NTX>(sum));
#pragma unroll
      for (int c = 0; c < TO; ++c) acc[i][c] = __fmul_rn(acc[i][c], alpha);
      m[i] = m_new;
    }
    __syncthreads();
    fma_tile<BQ, HD, TM, TO, BKV>(acc, Ps, TL::p_ld, Vs, HD, ty, tx);
    __syncthreads();
  }

  TQ* o = O + (size_t)bh * S * HD;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty + i * NTY;
    if (r >= S) continue;
    const float inv = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < TO; ++c) o[(size_t)r * HD + tx + c * NTX] = from_f32<TQ>(__fdiv_rn(acc[i][c], inv));
  }
}

template <typename TQ, typename TKV, bool QUANT, typename TL>
cudaError_t run(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                void* o, int B, int H, int Hkv, int S, int Sk, int causal, float sm_scale,
                cudaStream_t stream) {
  auto kernel = flash_kernel<TQ, TKV, QUANT, TL>;
  cudaError_t e = set_smem(kernel, TL::smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + TL::bq - 1) / TL::bq, B * H);
  kernel<<<grid, TL::threads, TL::smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs), static_cast<TQ*>(o), H,
      H / Hkv, S, Sk, causal, sm_scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------- wgmma --
// HD 128, 112 or 64; BQ q rows a block, 64 per consumer warpgroup (128 or
// 64).  A row is held in 64-wide boxes; at HD 112 the second box's last 16
// columns lie past the row, and TMA fills them with zeros.
template <int HD, int BQ>
struct FlashWgmma {
  static constexpr int kind = 2, dtypes = 2;  // wgmma; bf16
  static constexpr int kv = 1;                // native K/V
  static constexpr int hd = HD, bq = BQ, bkv = 128, tm = 64, tn = 128;
  static constexpr int stages = HD > 64 ? 2 : 4;        // K/V ring depth
  static constexpr int consumers = BQ / 64;             // warpgroups of 64 q rows
  static constexpr int threads = consumers * 128 + 32;  // and a producer warp
  static constexpr int boxes = (HD + 63) / 64;          // 64-wide boxes of a row
  static constexpr int q_box = BQ * 128;                // bytes of a box of the q tile
  static constexpr int kv_box = 128 * 128;              // bytes of a box of a K or V tile
  static constexpr int q_bytes = boxes * q_box;
  static constexpr int tile_bytes = boxes * kv_box;     // a K or V tile
  // 1024 to align to the swizzle atom; q; the K/V ring; the q barrier and
  // a full and an empty barrier per stage
  static constexpr int smem = 1024 + q_bytes + 2 * stages * tile_bytes + (1 + 2 * stages) * 8;
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// q [B*H, S, HD], k/v [B*Hkv, Sk, HD] as 3-D tensor maps (boxes of 64 x
// BQ, or 64 x 128, rows x 1); O [B*H, S, HD] bf16.  scale_log2 =
// hd^-0.5 * log2(e).  S = Q K^T takes HD / 16 k-steps (8, 7 or 4).  At HD
// 64 a tile row is one 128-byte box, and O += P V runs on wgmma m64n64k16
// with 32 accumulators a thread; at HD 128 and 112 on m64n128k16, and at
// 112 the product's last 16 columns (V's zero-filled ones) are not
// stored: 12.5% more P V work than the row needs.
template <typename TL>
__global__ void __launch_bounds__(TL::threads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_q,
                       const __grid_constant__ CUtensorMap tmap_k,
                       const __grid_constant__ CUtensorMap tmap_v, __nv_bfloat16* __restrict__ O,
                       int H, int groups, int S, int Sk, int causal, float scale_log2) {
  constexpr int HD = TL::hd, NB = TL::boxes, QBOX = TL::q_box, KBOX = TL::kv_box;
  constexpr int TB = TL::tile_bytes, ST = TL::stages, NC = TL::consumers;
  static_assert(HD % 16 == 0, "k-steps of 16 along hd");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Ks = Qs + TL::q_bytes;   // stage s at Ks + s * TB
  uint8_t* Vs = Ks + ST * TB;       // stage s at Vs + s * TB
  uint64_t* qbar = reinterpret_cast<uint64_t*>(Vs + ST * TB);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + ST;
  const int bh = blockIdx.y;  // b * H + h
  const int kvh = (bh / H) * (H / groups) + (bh % H) / groups;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // longest first
  const int q0 = qt * TL::bq;
  int n_kv = (Sk + TL::bkv - 1) / TL::bkv;
  if (causal) n_kv = min(n_kv, (min(q0 + TL::bq, S) - 1) / TL::bkv + 1);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NC) {  // the producer warp
    if (tid == 0) {
      mbar_expect_tx(qbar, TL::q_bytes);
#pragma unroll
      for (int b = 0; b < NB; ++b) tma_load_3d(Qs + b * QBOX, &tmap_q, qbar, 64 * b, q0, bh);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % ST;
        if (t >= ST) mbar_wait(&empty[s], (t / ST - 1) & 1);
        mbar_expect_tx(&full[s], 2 * TB);
        uint8_t* k = Ks + s * TB;
        uint8_t* v = Vs + s * TB;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(k + b * KBOX, &tmap_k, &full[s], 64 * b, t * TL::bkv, kvh);
          tma_load_3d(v + b * KBOX, &tmap_v, &full[s], 64 * b, t * TL::bkv, kvh);
        }
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;  // and row0 + 8
  float o[NB * 32], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NB * 32; ++i) o[i] = 0.f;
  mbar_wait(qbar, 0);
  const uint8_t* q = Qs + wg * 64 * 128;  // this warpgroup's 64 rows of each box

  for (int t = 0; t < n_kv; ++t) {
    const int s = t % ST;
    mbar_wait(&full[s], (t / ST) & 1);
    const uint8_t* k = Ks + s * TB;
    const uint8_t* v = Vs + s * TB;

    // S = Q K^T: HD / 16 steps of 16 along hd, 4 per 64-wide box
    float sc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int qoff = (kk / 4) * QBOX + 32 * (kk % 4);
      const int koff = (kk / 4) * KBOX + 32 * (kk % 4);
      wgmma_m64n128k16_ss<0>(sc, desc_b128(q + qoff, 16, 1024), desc_b128(k + koff, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // online softmax; register i: row row0 + 8 * ((i / 2) % 2), key
    // k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2
    const int k0 = t * TL::bkv;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qpos = row0 + 8 * h;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const int kpos = k0 + 8 * j + 2 * (lane % 4) + e;
          float x = __fmul_rn(sc[i], scale_log2);
          if (kpos >= Sk || (causal && kpos > qpos)) x = kNegInf;
          sc[i] = x;
          mx = fmaxf(mx, x);
        }
      }
      const float m_new = fmaxf(m[h], quad_max(mx));
      const float alpha = exp2f(__fsub_rn(m[h], m_new));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const float p = exp2f(__fsub_rn(sc[i], m_new));
          sc[i] = p;
          sum = __fadd_rn(sum, p);
        }
      }
      l[h] = __fadd_rn(__fmul_rn(l[h], alpha), quad_sum(sum));
      m[h] = m_new;
#pragma unroll
      for (int j = 0; j < NB * 8; ++j) {
        o[4 * j + 2 * h] = __fmul_rn(o[4 * j + 2 * h], alpha);
        o[4 * j + 2 * h + 1] = __fmul_rn(o[4 * j + 2 * h + 1], alpha);
      }
    }

    // O += P V: p in bf16 as wgmma's A fragment; keys 16 kk .. 16 kk + 15
    // are accumulator columns 8 (2 kk) .. 8 (2 kk + 1) + 7
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t a[4] = {pack_bf16(sc[8 * kk], sc[8 * kk + 1]),
                             pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]),
                             pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]),
                             pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7])};
      if constexpr (NB == 2) {
        wgmma_m64n128k16_rs<1>(o, a, desc_b128(v + 2048 * kk, KBOX, 1024));
      } else {
        wgmma_m64n64k16_rs<1>(o, a, desc_b128(v + 2048 * kk, KBOX, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (tid == 0) mbar_arrive(&empty[s]);
  }

  __nv_bfloat16* out = O + (size_t)bh * S * HD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= S) continue;
    const float inv = l[h] == 0.f ? 1.f : l[h];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * HD + col) =
          __floats2bfloat162_rn(__fdiv_rn(o[4 * j + 2 * h], inv),
                                __fdiv_rn(o[4 * j + 2 * h + 1], inv));
    }
  }
}

template <typename TL>
cudaError_t run_wgmma(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
                      int S, int Sk, int causal, float sm_scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const uint32_t q_box[2] = {64, (uint32_t)TL::bq}, kv_box[2] = {64, (uint32_t)TL::bkv};
  const uint64_t row = TL::hd * 2;
  const uint64_t q_dims[3] = {(uint64_t)TL::hd, (uint64_t)S, (uint64_t)B * H};
  const uint64_t q_strides[2] = {row, row * S};
  const uint64_t kv_dims[3] = {(uint64_t)TL::hd, (uint64_t)Sk, (uint64_t)B * Hkv};
  const uint64_t kv_strides[2] = {row, row * Sk};
  cudaError_t e = encode_tmap_bf16(&tq, q, 3, q_dims, q_strides, q_box);
  if (e == cudaSuccess) e = encode_tmap_bf16(&tk, k, 3, kv_dims, kv_strides, kv_box);
  if (e == cudaSuccess) e = encode_tmap_bf16(&tv, v, 3, kv_dims, kv_strides, kv_box);
  if (e != cudaSuccess) return e;
  auto kernel = flash_wgmma_kernel<TL>;
  e = set_smem(kernel, TL::smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + TL::bq - 1) / TL::bq, B * H);
  kernel<<<grid, TL::threads, TL::smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), H, H / Hkv, S, Sk, causal,
      sm_scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// ---------------------------------------------------- wgmma, quantized --
// HD 128, 112 or 64.  The converted bf16 tiles are the native kernel's,
// rows of 64-wide boxes; a code row is HD bytes.  At HD 112 the
// conversion leaves the last 16 columns of the second box unwritten: Q K^T
// stops at column HD, and V's columns there feed only the product's last
// 16 columns, which are not stored (wgmma columns do not mix).  The code
// stages are as many (1 or 2) as fit the card's 232,448 bytes: 2 at HD
// 112 and 64, 1 at HD 128 (a second would be 40 bytes over).
template <int HD>
struct FlashWgmmaQuant {
  static constexpr int kind = 2, dtypes = 2;  // wgmma; bf16 q
  static constexpr int kv = 2;                // int8 / e4m3 K/V with row scales
  static constexpr int hd = HD, bq = 128, bkv = 128, tm = 64, tn = 128;
  static constexpr int bufs = 2;                    // converted bf16 K/V tiles
  static constexpr int threads = 2 * 128 + 32;      // two consumer warpgroups, a producer warp
  static constexpr int boxes = (HD + 63) / 64;      // 64-wide boxes of a row
  static constexpr int box_bytes = 128 * 128;       // 128 rows of one box
  static constexpr int tile_bytes = boxes * box_bytes;  // q, or a bf16 K or V tile
  static constexpr int code_bytes = 128 * HD;       // a K or V code tile, 1 byte a value
  static constexpr int scale_bytes = 2 * 128 * 4;   // the K and V scales of one step
  static constexpr int smem_limit = 232448;         // an H100's opt-in shared memory
  // 1024 to align to the swizzle atom; q; the bf16 K and V tiles of each
  // buffer; the scales of each buffer; then the code stages (K and V) and
  // the q barrier, a full and an empty barrier per stage
  static constexpr int base = 1024 + tile_bytes * (1 + 2 * bufs) + bufs * scale_bytes;
  static constexpr int stages = base + 2 * 2 * code_bytes + 5 * 8 <= smem_limit ? 2 : 1;
  static constexpr int smem = base + stages * 2 * code_bytes + (1 + 2 * stages) * 8;
};

// q [B*H, S, HD] bf16 and the codes kc/vc [B*Hkv, Sk, HD] (1 byte a
// value) as 3-D tensor maps; KS/VS [B*Hkv, Sk] fp32 row scales; O
// [B*H, S, HD] bf16.  scale_log2 = hd^-0.5 * log2(e).
template <typename Q, typename TL>
__global__ void __launch_bounds__(TL::threads, 1)
    flash_wgmma_quant_kernel(const __grid_constant__ CUtensorMap tmap_q,
                             const __grid_constant__ CUtensorMap tmap_kc,
                             const __grid_constant__ CUtensorMap tmap_vc,
                             const float* __restrict__ KS, const float* __restrict__ VS,
                             __nv_bfloat16* __restrict__ O, int H, int groups, int S, int Sk,
                             int causal, float scale_log2) {
  constexpr int HD = TL::hd, NB = TL::boxes, TB = TL::tile_bytes, BOX = TL::box_bytes;
  constexpr int CB = TL::code_bytes, CS = TL::stages;
  constexpr int CT = 256;                   // consumer threads
  constexpr int IT = 2 * CB / 16 / CT;      // 16-code vectors a thread converts a step
  constexpr int RV = HD / 16;               // 16-code vectors of a code row
  static_assert(HD % 16 == 0 && (2 * CB / 16) % CT == 0, "whole code vectors a thread");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* KV = Qs + TB;                    // buffer b: K at KV + 2 b TB, V after it
  float* Sc = reinterpret_cast<float*>(KV + 2 * TL::bufs * TB);  // buffer b: 128 K, 128 V scales
  uint8_t* Cs = reinterpret_cast<uint8_t*>(Sc + TL::bufs * 256);  // stage s: K, V codes at s 2 CB
  uint64_t* qbar = reinterpret_cast<uint64_t*>(Cs + CS * 2 * CB);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + CS;
  const int bh = blockIdx.y;  // b * H + h
  const int kvh = (bh / H) * (H / groups) + (bh % H) / groups;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // longest first
  const int q0 = qt * TL::bq;
  int n_kv = (Sk + TL::bkv - 1) / TL::bkv;
  if (causal) n_kv = min(n_kv, (min(q0 + TL::bq, S) - 1) / TL::bkv + 1);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < CS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp
    if (tid == 0) {
      mbar_expect_tx(qbar, TB);
#pragma unroll
      for (int b = 0; b < NB; ++b) tma_load_3d(Qs + b * BOX, &tmap_q, qbar, 64 * b, q0, bh);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % CS;
        if (t >= CS) mbar_wait(&empty[s], (t / CS - 1) & 1);
        mbar_expect_tx(&full[s], 2 * CB);
        tma_load_3d(Cs + s * 2 * CB, &tmap_kc, &full[s], 0, t * TL::bkv, kvh);
        tma_load_3d(Cs + s * 2 * CB + CB, &tmap_vc, &full[s], 0, t * TL::bkv, kvh);
      }
    }
    return;
  }

  const int ct = threadIdx.x;  // 0 .. 255 over both consumer warpgroups
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;  // and row0 + 8
  const float* scale_src = (ct < 128 ? KS : VS) + (size_t)kvh * Sk;
  float o[NB * 32], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NB * 32; ++i) o[i] = 0.f;
  const uint8_t* q = Qs + wg * 64 * 128;  // this warpgroup's 64 rows of each box
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * TL::bkv, b = t % TL::bufs, s = t % CS;
    const uint8_t* codes = Cs + s * 2 * CB;
    uint8_t* k = KV + 2 * b * TB;
    uint8_t* v = k + TB;
    const float* sc_k = Sc + b * 256;
    const float* sc_v = sc_k + 128;
    // this thread's scale: key ct % 128 of K (ct < 128) or of V, zero
    // past Sk; the load is in flight while the codes land
    const int key = k0 + ct % 128;
    const float scale = key < Sk ? __ldg(scale_src + key) : 0.f;
    mbar_wait(&full[s], (t / CS) & 1);
    // Convert stage s into buffer b, as TMA writes a bf16 [keys, hd]
    // tile: 64-wide boxes, 128-byte swizzled.  Buffer b was last read
    // by the products of step t - 2, which both warpgroups had waited for
    // before the barrier of step t - 1.  All of a thread's code vectors
    // are loaded before its first store.
    uint4 cv[IT];
#pragma unroll
    for (int it = 0; it < IT; ++it)
      cv[it] = *reinterpret_cast<const uint4*>(codes + 16 * (it * CT + ct));
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int i = it * CT + ct;          // 16-code vector i of the stage
      const int which = i / (CB / 16);     // 0: K, 1: V
      const int r = (i % (CB / 16)) / RV;  // key row
      const int g = i % RV;                // codes 16 g .. 16 g + 15 of the row
      uint4 lo, hi;
      codes16_to_bf16<Q>(cv[it], lo, hi);
      uint8_t* dst = which ? v : k;
      *reinterpret_cast<uint4*>(dst + sw128_offset(r, 2 * g, 128)) = lo;
      *reinterpret_cast<uint4*>(dst + sw128_offset(r, 2 * g + 1, 128)) = hi;
    }
    Sc[b * 256 + ct] = scale;
    // the writes, made visible to wgmma (the async proxy) and complete in
    // both consumer warpgroups before either reads them; then the stage
    // is free for the next step's codes
    fence_proxy_async();
    named_bar_sync(1, CT);
    if (ct == 0) mbar_arrive(&empty[s]);
    if (t == 0) mbar_wait(qbar, 0);

    // S = Q codes_K^T: HD / 16 steps of 16 along hd, 4 per 64-wide box
    float sc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int off = (kk / 4) * BOX + 32 * (kk % 4);
      wgmma_m64n128k16_ss<0>(sc, desc_b128(q + off, 16, 1024), desc_b128(k + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // online softmax on s = (q . code) * ks * scale_log2; register i: row
    // row0 + 8 * ((i / 2) % 2), key k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2.
    // p goes back into sc as p' = p * vs, the A operand of P' codes_V.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qpos = row0 + 8 * h;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * j + 2 * (lane % 4);
        const float2 ks = *reinterpret_cast<const float2*>(sc_k + c);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const int kpos = k0 + c + e;
          float x = __fmul_rn(__fmul_rn(sc[i], e ? ks.y : ks.x), scale_log2);
          if (kpos >= Sk || (causal && kpos > qpos)) x = kNegInf;
          sc[i] = x;
          mx = fmaxf(mx, x);
        }
      }
      const float m_new = fmaxf(m[h], quad_max(mx));
      const float alpha = exp2f(__fsub_rn(m[h], m_new));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 vs = *reinterpret_cast<const float2*>(sc_v + 8 * j + 2 * (lane % 4));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const float p = exp2f(__fsub_rn(sc[i], m_new));
          sum = __fadd_rn(sum, p);
          sc[i] = __fmul_rn(p, e ? vs.y : vs.x);
        }
      }
      l[h] = __fadd_rn(__fmul_rn(l[h], alpha), quad_sum(sum));
      m[h] = m_new;
#pragma unroll
      for (int j = 0; j < NB * 8; ++j) {
        o[4 * j + 2 * h] = __fmul_rn(o[4 * j + 2 * h], alpha);
        o[4 * j + 2 * h + 1] = __fmul_rn(o[4 * j + 2 * h + 1], alpha);
      }
    }

    // O += P' codes_V: p' in bf16 as wgmma's A fragment (as the native
    // kernel's P V)
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t a[4] = {pack_bf16(sc[8 * kk], sc[8 * kk + 1]),
                             pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]),
                             pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]),
                             pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7])};
      if constexpr (NB == 2) {
        wgmma_m64n128k16_rs<1>(o, a, desc_b128(v + 2048 * kk, BOX, 1024));
      } else {
        wgmma_m64n64k16_rs<1>(o, a, desc_b128(v + 2048 * kk, BOX, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }

  __nv_bfloat16* out = O + (size_t)bh * S * HD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= S) continue;
    const float inv = l[h] == 0.f ? 1.f : l[h];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * HD + col) =
          __floats2bfloat162_rn(__fdiv_rn(o[4 * j + 2 * h], inv),
                                __fdiv_rn(o[4 * j + 2 * h + 1], inv));
    }
  }
}

template <typename Q, typename TL>
cudaError_t run_wgmma_quant(const void* q, const void* kc, const void* vc, const void* ks,
                            const void* vs, void* o, int B, int H, int Hkv, int S, int Sk,
                            int causal, float sm_scale, cudaStream_t stream) {
  // TMA: 16-byte aligned bases (the row strides, 2 HD and HD bytes, are)
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(kc) |
       reinterpret_cast<uintptr_t>(vc)) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  const uint32_t q_box[2] = {64, (uint32_t)TL::bq};
  const uint64_t q_dims[3] = {(uint64_t)TL::hd, (uint64_t)S, (uint64_t)B * H};
  const uint64_t q_strides[2] = {TL::hd * 2, (uint64_t)TL::hd * 2 * S};
  const uint32_t c_box[2] = {(uint32_t)TL::hd, (uint32_t)TL::bkv};
  const uint64_t c_dims[3] = {(uint64_t)TL::hd, (uint64_t)Sk, (uint64_t)B * Hkv};
  const uint64_t c_strides[2] = {TL::hd, (uint64_t)TL::hd * Sk};
  cudaError_t e = encode_tmap_bf16(&tq, q, 3, q_dims, q_strides, q_box);
  if (e == cudaSuccess)
    e = encode_tmap(&tk, CU_TENSOR_MAP_DATA_TYPE_UINT8, CU_TENSOR_MAP_SWIZZLE_NONE, kc, 3, c_dims,
                    c_strides, c_box);
  if (e == cudaSuccess)
    e = encode_tmap(&tv, CU_TENSOR_MAP_DATA_TYPE_UINT8, CU_TENSOR_MAP_SWIZZLE_NONE, vc, 3, c_dims,
                    c_strides, c_box);
  if (e != cudaSuccess) return e;
  auto kernel = flash_wgmma_quant_kernel<Q, TL>;
  e = set_smem(kernel, TL::smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + TL::bq - 1) / TL::bq, B * H);
  kernel<<<grid, TL::threads, TL::smem, stream>>>(
      tq, tk, tv, static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<__nv_bfloat16*>(o), H, H / Hkv, S, Sk, causal, sm_scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// The compiled tile menu, by index (kernels/flash_attention.py::TILES).
using A0 = AttnTile<32, 64, 64, 4, 4>;
using A1 = AttnTile<32, 128, 128, 8, 8>;
using A2 = AttnTile<64, 64, 64, 4, 4>;
using A3 = AttnTile<64, 128, 128, 8, 8>;
using A4 = AttnTile<128, 64, 64, 4, 4>;
using A5 = AttnTile<128, 128, 64, 8, 4>;
using A6 = FlashWgmma<128, 128>;    // bf16, native K/V, hd 128
using A7 = FlashWgmmaQuant<128>;    // bf16, int8 / e4m3 K/V, hd 128
using A8 = FlashWgmma<64, 128>;     // bf16, native K/V, hd 64
using A9 = FlashWgmma<64, 64>;      // bf16, native K/V, hd 64, one warpgroup
using A10 = AttnTile<112, 64, 64, 4, 4>;
using A11 = AttnTile<112, 128, 64, 8, 4>;
using A12 = FlashWgmma<112, 128>;   // bf16, native K/V, hd 112
using A13 = FlashWgmmaQuant<112>;   // bf16, int8 / e4m3 K/V, hd 112
using A14 = FlashWgmmaQuant<64>;    // bf16, int8 / e4m3 K/V, hd 64

template <typename TQ, typename TKV, bool QUANT>
int dispatch(int tile, const void* q, const void* k, const void* v, const void* ks,
             const void* vs, void* o, int B, int H, int Hkv, int S, int Sk, int causal,
             float sm_scale, cudaStream_t s) {
  switch (tile) {
    case 0: return run<TQ, TKV, QUANT, A0>(q, k, v, ks, vs, o, B, H, Hkv, S, Sk, causal, sm_scale, s);
    case 1: return run<TQ, TKV, QUANT, A1>(q, k, v, ks, vs, o, B, H, Hkv, S, Sk, causal, sm_scale, s);
    case 2: return run<TQ, TKV, QUANT, A2>(q, k, v, ks, vs, o, B, H, Hkv, S, Sk, causal, sm_scale, s);
    case 3: return run<TQ, TKV, QUANT, A3>(q, k, v, ks, vs, o, B, H, Hkv, S, Sk, causal, sm_scale, s);
    case 4: return run<TQ, TKV, QUANT, A4>(q, k, v, ks, vs, o, B, H, Hkv, S, Sk, causal, sm_scale, s);
    case 5: return run<TQ, TKV, QUANT, A5>(q, k, v, ks, vs, o, B, H, Hkv, S, Sk, causal, sm_scale, s);
    case 10: return run<TQ, TKV, QUANT, A10>(q, k, v, ks, vs, o, B, H, Hkv, S, Sk, causal, sm_scale, s);
    case 11: return run<TQ, TKV, QUANT, A11>(q, k, v, ks, vs, o, B, H, Hkv, S, Sk, causal, sm_scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ>
int dispatch_kv(int kv_kind, int tile, const void* q, const void* k, const void* v,
                const void* ks, const void* vs, void* o, int B, int H, int Hkv, int S, int Sk,
                int causal, float sm_scale, cudaStream_t s) {
  switch (kv_kind) {
    case 0: return dispatch<TQ, TQ, false>(tile, q, k, v, ks, vs, o, B, H, Hkv, S, Sk, causal, sm_scale, s);
    case 1: return dispatch<TQ, int8_t, true>(tile, q, k, v, ks, vs, o, B, H, Hkv, S, Sk, causal, sm_scale, s);
    case 2: return dispatch<TQ, __nv_fp8_e4m3, true>(tile, q, k, v, ks, vs, o, B, H, Hkv, S, Sk, causal, sm_scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Q>
int run_wgmma_quant_tile(int tile, const void* q, const void* kc, const void* vc,
                         const void* ks, const void* vs, void* o, int B, int H, int Hkv, int S,
                         int Sk, int causal, float sm_scale, cudaStream_t s) {
  switch (tile) {
    case 7: return run_wgmma_quant<Q, A7>(q, kc, vc, ks, vs, o, B, H, Hkv, S, Sk, causal, sm_scale, s);
    case 13: return run_wgmma_quant<Q, A13>(q, kc, vc, ks, vs, o, B, H, Hkv, S, Sk, causal, sm_scale, s);
    case 14: return run_wgmma_quant<Q, A14>(q, kc, vc, ks, vs, o, B, H, Hkv, S, Sk, causal, sm_scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TL>
void describe(int* out) {
  out[0] = TL::kind; out[1] = TL::dtypes;
  out[2] = TL::hd; out[3] = TL::bq; out[4] = TL::bkv;
  out[5] = TL::tm; out[6] = TL::tn; out[7] = TL::kv; out[8] = TL::smem;
}

}  // namespace repro

extern "C" {

// q_bf16: q (and native K/V, and O) are bf16 (1) or fp32 (0).  kv_kind:
// 0 native (K/V in q's type, ks/vs unused), 1 int8, 2 float8_e4m3 (K/V
// quantized, fp32 row scales ks/vs [B,Hkv,Sk]).
int flash_attention_fwd(const void* q, const void* k, const void* v, const void* ks,
                        const void* vs, void* o, int q_bf16, int kv_kind, int B, int H, int Hkv,
                        int S, int Sk, int causal, float sm_scale, int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 6 || tile == 8 || tile == 9 || tile == 12) {
    if (!q_bf16 || kv_kind != 0) return cudaErrorInvalidValue;
    if (tile == 6)
      return repro::run_wgmma<repro::A6>(q, k, v, o, B, H, Hkv, S, Sk, causal, sm_scale, s);
    if (tile == 8)
      return repro::run_wgmma<repro::A8>(q, k, v, o, B, H, Hkv, S, Sk, causal, sm_scale, s);
    if (tile == 12)
      return repro::run_wgmma<repro::A12>(q, k, v, o, B, H, Hkv, S, Sk, causal, sm_scale, s);
    return repro::run_wgmma<repro::A9>(q, k, v, o, B, H, Hkv, S, Sk, causal, sm_scale, s);
  }
  if (tile == 7 || tile == 13 || tile == 14) {
    if (!q_bf16) return cudaErrorInvalidValue;
    if (kv_kind == 1)
      return repro::run_wgmma_quant_tile<int8_t>(tile, q, k, v, ks, vs, o, B, H, Hkv, S, Sk,
                                                 causal, sm_scale, s);
    if (kv_kind == 2)
      return repro::run_wgmma_quant_tile<__nv_fp8_e4m3>(tile, q, k, v, ks, vs, o, B, H, Hkv, S,
                                                        Sk, causal, sm_scale, s);
    return cudaErrorInvalidValue;
  }
  if (q_bf16)
    return repro::dispatch_kv<__nv_bfloat16>(kv_kind, tile, q, k, v, ks, vs, o, B, H, Hkv, S, Sk,
                                             causal, sm_scale, s);
  return repro::dispatch_kv<float>(kv_kind, tile, q, k, v, ks, vs, o, B, H, Hkv, S, Sk, causal,
                                   sm_scale, s);
}

// Writes (kind, dtypes, hd, bq, bkv, tm, tn, K/V, shared-memory bytes) of
// menu entry `tile` (kind 0 simt, 2 wgmma; dtypes a mask, 1 fp32, 2 bf16;
// K/V a mask, 1 native, 2 quantized); returns the number of entries.
int flash_attention_tile(int tile, int* out) {
  switch (tile) {
    case 0: repro::describe<repro::A0>(out); break;
    case 1: repro::describe<repro::A1>(out); break;
    case 2: repro::describe<repro::A2>(out); break;
    case 3: repro::describe<repro::A3>(out); break;
    case 4: repro::describe<repro::A4>(out); break;
    case 5: repro::describe<repro::A5>(out); break;
    case 6: repro::describe<repro::A6>(out); break;
    case 7: repro::describe<repro::A7>(out); break;
    case 8: repro::describe<repro::A8>(out); break;
    case 9: repro::describe<repro::A9>(out); break;
    case 10: repro::describe<repro::A10>(out); break;
    case 11: repro::describe<repro::A11>(out); break;
    case 12: repro::describe<repro::A12>(out); break;
    case 13: repro::describe<repro::A13>(out); break;
    case 14: repro::describe<repro::A14>(out); break;
    default: break;
  }
  return 15;
}

}  // extern "C"
