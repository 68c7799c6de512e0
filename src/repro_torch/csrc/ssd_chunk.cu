// ssd_chunk for Hopper (sm_90a): the intra-chunk part of Mamba2's SSD
// (state-space duality) scan.  For each (b*h, chunk) of Q positions:
//
//   cum    = cumsum(-dt * A) over the chunk
//   L[i,j] = exp(cum_i - cum_j) for i >= j, 0 above the diagonal
//   y_diag = ((C B^T) o L o dt_j) x                      [Q, P]
//   state  = (B o (exp(cum_last - cum) * dt))^T x        [N, P]
//
// x [BH,S,P] and B, C in the compute type (fp32 or bf16); dt [BH,S] and
// A [BH] fp32; y [BH,S,P] and states [BH,S/Q,N,P] fp32.  All arithmetic
// is fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::ssd_chunk
// (:49, pallas_call at :62; body _ssd_chunk_kernel), which gives one grid
// cell a whole chunk: its [Q x Q] decay and score tiles live in VMEM.
// Here a full chunk does not fit one thread block (at Q = 256, L alone
// is 256 KiB fp32, above the 227 KB of shared memory a block may have),
// so a chunk is cut into blocks of two roles, all in one launch:
//
//   * y blocks: 64 query rows each.  The block loops over the 64-column
//     tiles j <= i (the tiles above the diagonal are skipped), builds the
//     [64 x 64] score tile C B^T in registers, multiplies in L and dt_j
//     where i >= j (L is computed only there, so no inf ever reaches a
//     product, where the reference masks the exponent to -inf first),
//     writes the weights to shared memory and accumulates W x into a
//     [64 x P] register tile.
//   * state blocks: 64 state rows (n) each, reducing over all Q rows in
//     64-row tiles, in a fixed order, with no atomics.
//
// Every block recomputes cum for the whole chunk from dt, one thread in
// order 0..Q-1 with explicitly rounded intrinsics, so all blocks of a
// chunk see the same cum bit for bit.  Every sum runs in one fixed order,
// so two launches on the same inputs are bit-identical.  The chunk
// length Q is a runtime value from 1 to 256 (the plan lowers 256, 128 or
// 64; a prompt's tail runs as a chunk of its own length); ragged row and
// column tiles are masked, not padded.
//
// B and C are shared by the heads of a batch row: in the model they are
// [b, S, N], and block (b*h) reads row bh / heads (heads = 1 for the
// reference's broadcast [BH, S, N] layout), as the flash kernel's GQA map
// does, so no broadcast copy reaches device memory.
//
// Bound on the H100: at the prefill path's shape (B 2, S 1024, 32 heads
// of P 64, N 128, Q 256) the function moves ~35 MB (x bf16 8.4 MB, B and
// C once per batch row 1 MB, y 16.8 MB and states 8.4 MB fp32) against
// ~4.3 GFLOP (the causal half of the two [Q x Q] products, and the
// states): 0.010 ms at 3.35 TB/s against 0.004 ms at the bf16 tensor-core
// peak, so it is bound by bytes.  Two kinds, one launch each:
//
//  * simt (every fp32 call; bf16 where asked): the first version, plain
//    fp32 FMA from shared memory, cum by one thread in order.  It keeps
//    the fp32 contracts (chunk exactness of the SSM prefill) as they were.
//  * wgmma (bf16 x, B, C with N a multiple of 16 up to 256 and P 32 or
//    64): the same roles, one warpgroup a block, on the tensor cores.  A
//    y block is flash attention without the softmax: S = C B^T by wgmma
//    m64n64k16 from shared memory (bf16 x bf16 products are exact, fp32
//    sums; both K-major, 128-byte swizzled, written by the block's
//    threads), W = S o L o dt_j on the accumulator fragment where i >= j
//    (L formed only there, as above), then y += W x with W as wgmma's
//    register A operand and x's [keys, P] tile MN-major (the transpose
//    bit), as flash attention's P V.  A state block forms (B o w)^T for
//    64 state rows and 64 positions in shared memory (M-major: the
//    transpose bit on A) and runs state += (B o w)^T x over the chunk's
//    position tiles in order.  The reference's contractions are fp32 and
//    x, B, C are bf16 (exact on the tensor cores); only the fp32 weights
//    (W and B o w) would lose precision in bf16, so each is split into
//    hi = bf16(w) and lo = bf16(w - hi) and both products go into the
//    same accumulator: the weights keep about 16 bits (w - hi - lo is
//    within 2^-16 of |w|).  cum is a warp scan in a fixed order (lanes
//    take contiguous runs, then shuffles), run alike by every block of a
//    chunk; it differs from an in-order sum only at fp32 rounding.
//
// Plain C interface for ctypes: ssd_chunk_fwd returns the CUDA error of
// the launch (0 on success); ssd_chunk_smem_bytes gives the shared
// memory of a launch, which kernels/ssd_scan.py::smem_bytes mirrors.
#include <cstdint>

#include "hopper_async.cuh"
#include "tile_common.cuh"

namespace repro {

constexpr int kMaxChunk = 256;        // longest chunk (the arch default)
constexpr int kBQ = 64;               // query rows per y block
constexpr int kBKV = 64;              // column (and state reduction) tile
constexpr int kBN = 64;               // state rows per state block
constexpr int kTM = 4, kTN = 4;       // register tile of the score tile
constexpr int kNTX = kBKV / kTN;      // 16 threads across columns
constexpr int kNTY = kBQ / kTM;       // 16 threads across rows
constexpr int kThreads = kNTX * kNTY;
static_assert(kBQ == kBKV, "column tiles align with row tiles");
static_assert(kBN / kTM == kNTY, "state rows use the y rows' thread map");

// Shared memory, in floats, after the two [kMaxChunk] stripes (cum, and
// dt or the state weights).
__host__ __device__ constexpr int y_floats(int N, int P) {
  return N * (kBQ + 1) + N * (kBKV + 1) + kBKV * P + kBKV * (kBQ + 1);
}
__host__ __device__ constexpr int state_floats(int P) { return kBKV * kBN + kBKV * P; }
__host__ __device__ constexpr int smem_bytes(int N, int P) {
  return (int)sizeof(float) *
         (2 * kMaxChunk + (y_floats(N, P) > state_floats(P) ? y_floats(N, P) : state_floats(P)));
}

// Rows [r0, r0 + R) of a chunk's [Q x W] row-major slab (row stride W)
// into shared memory as fp32, zero past row Q.  TRANSPOSE stores
// dst[c * ld + r], else dst[r * ld + c].  Consecutive threads read
// consecutive columns, so a warp's loads coalesce.
template <typename T, int R, bool TRANSPOSE>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* __restrict__ src, int Q,
                                          int W, int r0) {
  for (int idx = threadIdx.x; idx < R * W; idx += kThreads) {
    const int r = idx / W, c = idx % W;
    const int q = r0 + r;
    const float v = q < Q ? to_f32(src[(size_t)q * W + c]) : 0.f;
    if (TRANSPOSE) {
      dst[c * ld + r] = v;
    } else {
      dst[r * ld + c] = v;
    }
  }
}

// Query rows [i0, i0 + kBQ) of the chunk: y = sum over j <= i of
// (C_i . B_j) * exp(cum_i - cum_j) * dt_j * x_j.
template <typename T, int P>
__device__ __forceinline__ void y_block(const T* __restrict__ x, const T* __restrict__ Bm,
                                        const T* __restrict__ Cm, float* __restrict__ y,
                                        const float* cum, const float* dt, float* work, int Q,
                                        int N, int i0) {
  constexpr int TO = P / kNTX;
  float* Cs = work;                   // [N][kBQ+1], n-major
  float* Bs = Cs + N * (kBQ + 1);     // [N][kBKV+1], n-major
  float* Xs = Bs + N * (kBKV + 1);    // [kBKV][P]
  float* Ws = Xs + kBKV * P;          // [kBKV][kBQ+1], column-major weights
  const int tx = threadIdx.x % kNTX, ty = threadIdx.x / kNTX;
  load_rows<T, kBQ, true>(Cs, kBQ + 1, Cm, Q, N, i0);

  float acc[kTM][TO];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int c = 0; c < TO; ++c) acc[i][c] = 0.f;

  const int n_kv = (min(i0 + kBQ, Q) - 1) / kBKV + 1;  // tiles j <= i only
  for (int t = 0; t < n_kv; ++t) {
    const int j0 = t * kBKV;
    load_rows<T, kBKV, true>(Bs, kBKV + 1, Bm, Q, N, j0);
    load_rows<T, kBKV, false>(Xs, P, x, Q, P, j0);
    __syncthreads();

    float s[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = Cs[n * (kBQ + 1) + ty + i * kNTY];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = Bs[n * (kBKV + 1) + tx + j * kNTX];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int gi = i0 + ty + i * kNTY;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int gj = j0 + tx + j * kNTX;
        float w = 0.f;
        if (gj <= gi && gi < Q) {
          // scores * L * dt_j, in the reference kernel's order
          w = __fmul_rn(__fmul_rn(s[i][j], expf(__fsub_rn(cum[gi], cum[gj]))), dt[gj]);
        }
        Ws[(tx + j * kNTX) * (kBQ + 1) + ty + i * kNTY] = w;
      }
    }
    __syncthreads();
    fma_tile<kBQ, P, kTM, TO, kBKV>(acc, Ws, kBQ + 1, Xs, P, ty, tx);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gi = i0 + ty + i * kNTY;
    if (gi >= Q) continue;
#pragma unroll
    for (int c = 0; c < TO; ++c) y[(size_t)gi * P + tx + c * kNTX] = acc[i][c];
  }
}

// State rows [n0, n0 + kBN) of the chunk: state[n, p] = sum over q of
// B[q, n] * (exp(cum_last - cum_q) * dt_q) * x[q, p]; `w` holds the
// bracket per q.
template <typename T, int P>
__device__ __forceinline__ void state_block(const T* __restrict__ x, const T* __restrict__ Bm,
                                            float* __restrict__ st, const float* w, float* work,
                                            int Q, int N, int n0) {
  constexpr int TO = P / kNTX;
  float* Bw = work;                   // [kBKV][kBN], q-major
  float* Xs = Bw + kBKV * kBN;        // [kBKV][P]
  const int tx = threadIdx.x % kNTX, ty = threadIdx.x / kNTX;

  float acc[kTM][TO];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int c = 0; c < TO; ++c) acc[i][c] = 0.f;

  for (int q0 = 0; q0 < Q; q0 += kBKV) {
    for (int idx = threadIdx.x; idx < kBKV * kBN; idx += kThreads) {
      const int r = idx / kBN, c = idx % kBN;
      const int q = q0 + r, n = n0 + c;
      // B * (decay_out * dt), the reference kernel's order
      Bw[idx] = (q < Q && n < N) ? __fmul_rn(to_f32(Bm[(size_t)q * N + n]), w[q]) : 0.f;
    }
    load_rows<T, kBKV, false>(Xs, P, x, Q, P, q0);
    __syncthreads();
    fma_tile<kBN, P, kTM, TO, kBKV>(acc, Bw, kBN, Xs, P, ty, tx);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int n = n0 + ty + i * kNTY;
    if (n >= N) continue;
#pragma unroll
    for (int c = 0; c < TO; ++c) st[(size_t)n * P + tx + c * kNTX] = acc[i][c];
  }
}

// Grid: x = b*h * n_c + chunk, y = role (the y blocks, longest first,
// then the state blocks).
template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_kernel(const T* __restrict__ X, const float* __restrict__ DT,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, float* __restrict__ Y, float* __restrict__ ST,
                     int S, int Q, int N, int heads, int n_row) {
  extern __shared__ float smem[];
  float* cum = smem;                  // [kMaxChunk]
  float* aux = smem + kMaxChunk;      // [kMaxChunk]: dt, or the state weights
  float* work = smem + 2 * kMaxChunk;
  const int n_c = S / Q;
  const int bh = blockIdx.x / n_c, c = blockIdx.x % n_c;
  const size_t row0 = (size_t)bh * S + (size_t)c * Q;           // x, dt, y rows
  const size_t bc0 = (size_t)(bh / heads) * S + (size_t)c * Q;  // B, C rows

  for (int q = threadIdx.x; q < Q; q += kThreads) aux[q] = DT[row0 + q];
  __syncthreads();
  if (threadIdx.x == 0) {
    const float a = A[bh];
    float run = 0.f;
    for (int q = 0; q < Q; ++q) {
      run = __fadd_rn(run, __fmul_rn(-aux[q], a));
      cum[q] = run;
    }
  }
  __syncthreads();

  const int role = blockIdx.y;
  if (role < n_row) {
    const int rt = n_row - 1 - role;  // the longest row tiles first
    y_block<T, P>(X + row0 * P, Bm + bc0 * N, Cm + bc0 * N, Y + row0 * P, cum, aux, work, Q, N,
                  rt * kBQ);
  } else {
    const float last = cum[Q - 1];
    for (int q = threadIdx.x; q < Q; q += kThreads)
      aux[q] = __fmul_rn(expf(__fsub_rn(last, cum[q])), aux[q]);
    __syncthreads();
    state_block<T, P>(X + row0 * P, Bm + bc0 * N,
                      ST + ((size_t)bh * n_c + c) * (size_t)N * P, aux, work, Q, N,
                      (role - n_row) * kBN);
  }
}

template <typename T, int P>
cudaError_t run(const void* x, const void* dt, const void* A, const void* B, const void* C,
                void* y, void* st, int BH, int S, int Q, int N, int heads, cudaStream_t stream) {
  auto kernel = ssd_chunk_kernel<T, P>;
  const int smem = smem_bytes(N, P);
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int n_row = (Q + kBQ - 1) / kBQ;
  const int n_state = (N + kBN - 1) / kBN;
  dim3 grid((unsigned)BH * (unsigned)(S / Q), n_row + n_state);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<float*>(y),
      static_cast<float*>(st), S, Q, N, heads, n_row);
  return cudaGetLastError();
}

template <typename T>
int dispatch(int P, const void* x, const void* dt, const void* A, const void* B, const void* C,
             void* y, void* st, int BH, int S, int Q, int N, int heads, cudaStream_t s) {
  switch (P) {
    case 16: return run<T, 16>(x, dt, A, B, C, y, st, BH, S, Q, N, heads, s);
    case 32: return run<T, 32>(x, dt, A, B, C, y, st, BH, S, Q, N, heads, s);
    case 64: return run<T, 64>(x, dt, A, B, C, y, st, BH, S, Q, N, heads, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- wgmma --
constexpr int kWRows = 64;            // rows of every tile: query, key, state, position
constexpr int kWBox = kWRows * 128;   // one 128-byte-swizzled box: 64 rows of 64 bf16
constexpr int kWThreads = 128;        // one warpgroup a block
constexpr int kWMaxState = 256;

__host__ __device__ constexpr int w_boxes(int N) { return (N + 63) / 64; }
// Alignment to the swizzle atom, the cum and dt (or state weight)
// stripes, and the larger role's tiles: C, B [64 x N] and x [64 x P] (y
// blocks); the hi and lo (B o w) tiles and x (state blocks).
__host__ __device__ constexpr int wgmma_smem_bytes(int N) {
  return 1024 + 2 * kMaxChunk * (int)sizeof(float) +
         (2 * w_boxes(N) + 1 > 3 ? 2 * w_boxes(N) + 1 : 3) * kWBox;
}

// Rows [r0, r0 + 64) of a chunk's [Q x W] bf16 slab (row stride W, a
// multiple of 8) into shared memory as 64-row boxes, 128-byte swizzled,
// zero past row Q.  16-byte loads, four in flight a thread.
__device__ __forceinline__ void load_sw128(uint8_t* dst, const __nv_bfloat16* __restrict__ src,
                                           int Q, int W, int r0) {
  const int cpr = W / 8;  // 16-byte chunks a row
  const int total = kWRows * cpr;
  for (int base = 0; base < total; base += 4 * kWThreads) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * kWThreads + threadIdx.x;
      const int r = i / cpr;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < total && r0 + r < Q)
        v[u] = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * W) + i % cpr);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * kWThreads + threadIdx.x;
      if (i < total) *reinterpret_cast<uint4*>(dst + sw128_offset(i / cpr, i % cpr, kWRows)) = v[u];
    }
  }
}

// Two fp32 weights as bf16 pairs hi = bf16(w) and lo = bf16(w - hi)
// (w - hi is exact in fp32), element a in the low halves.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(__fsub_rn(a, hf.x), __fsub_rn(b, hf.y));
}

template <int P>
__device__ __forceinline__ void mma_rs(float (&d)[P / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (P == 64) {
    wgmma_m64n64k16_rs<1>(d, a, b);
  } else {
    wgmma_m64n32k16_rs<1>(d, a, b);
  }
}

template <int P>
__device__ __forceinline__ void mma_ss_t(float (&d)[P / 2], uint64_t a, uint64_t b) {
  if constexpr (P == 64) {
    wgmma_m64n64k16_ss<1, 1>(d, a, b);
  } else {
    wgmma_m64n32k16_ss<1, 1>(d, a, b);
  }
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

// Query rows [i0, i0 + 64) of the chunk, as y_block does, on the tensor
// cores.  Accumulator register i of a [64 x n] wgmma tile: row
// 16 * warp + lane / 4 + 8 * ((i / 2) % 2), column 8 * (i / 4) +
// 2 * (lane % 4) + i % 2.
template <int P>
__device__ __forceinline__ void y_block_wgmma(const __nv_bfloat16* __restrict__ x,
                                              const __nv_bfloat16* __restrict__ Bm,
                                              const __nv_bfloat16* __restrict__ Cm,
                                              float* __restrict__ y, const float* cum,
                                              const float* dt, uint8_t* work, int Q, int N,
                                              int i0) {
  const int nb = w_boxes(N);
  uint8_t* Cs = work;              // [64 rows][N], K-major
  uint8_t* Bs = Cs + nb * kWBox;   // [64 keys][N], K-major
  uint8_t* Xs = Bs + nb * kWBox;   // [64 keys][P], MN-major
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = i0 + 16 * warp + lane / 4;  // and r0 + 8
  load_sw128(Cs, Cm, Q, N, i0);

  float acc[P / 2];
#pragma unroll
  for (int i = 0; i < P / 2; ++i) acc[i] = 0.f;
  const int n_kv = (min(i0 + kWRows, Q) - 1) / kWRows + 1;  // tiles j <= i only
  for (int t = 0; t < n_kv; ++t) {
    const int j0 = t * kWRows;
    if (t > 0) __syncthreads();  // every thread's products of tile t - 1 are done
    load_sw128(Bs, Bm, Q, N, j0);
    load_sw128(Xs, x, Q, P, j0);
    fence_proxy_async();
    __syncthreads();

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
    for (int kk = 0; kk < N / 16; ++kk) {
      const int off = (kk / 4) * kWBox + 32 * (kk % 4);
      wgmma_m64n64k16_ss<0, 0>(s, desc_b128(Cs + off, 16, 1024), desc_b128(Bs + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int gi = r0 + 8 * ((i / 2) % 2);
      const int gj = j0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
      float w = 0.f;
      if (gj <= gi && gi < Q) {
        // scores * L * dt_j, in the reference kernel's order
        w = __fmul_rn(__fmul_rn(s[i], expf(__fsub_rn(cum[gi], cum[gj]))), dt[gj]);
      }
      s[i] = w;
    }

    // y += (hi + lo) x: keys 16 kk .. 16 kk + 15 are accumulator columns
    // 8 (2 kk) .. 8 (2 kk + 1) + 7
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) split_bf16(s[8 * kk + 2 * u], s[8 * kk + 2 * u + 1], hi[u], lo[u]);
      const uint64_t xd = desc_b128(Xs + 2048 * kk, kWBox, 1024);
      mma_rs<P>(acc, hi, xd);
      mma_rs<P>(acc, lo, xd);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

#pragma unroll
  for (int i = 0; i < P / 2; i += 2) {
    const int gi = r0 + 8 * ((i / 2) % 2);
    if (gi < Q)
      *reinterpret_cast<float2*>(y + (size_t)gi * P + 8 * (i / 4) + 2 * (lane % 4)) =
          make_float2(acc[i], acc[i + 1]);
  }
}

// State rows [n0, n0 + 64) of the chunk, as state_block does, on the
// tensor cores; `w` holds the bracket per position.
template <int P>
__device__ __forceinline__ void state_block_wgmma(const __nv_bfloat16* __restrict__ x,
                                                  const __nv_bfloat16* __restrict__ Bm,
                                                  float* __restrict__ st, const float* w,
                                                  uint8_t* work, int Q, int N, int n0) {
  uint8_t* Hs = work;          // hi of (B o w) [64 positions][64 n], M-major A
  uint8_t* Ls = Hs + kWBox;    // lo
  uint8_t* Xs = Ls + kWBox;    // [64 positions][P], MN-major
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[P / 2];
#pragma unroll
  for (int i = 0; i < P / 2; ++i) acc[i] = 0.f;

  for (int q0 = 0; q0 < Q; q0 += kWRows) {
    if (q0 > 0) __syncthreads();  // every thread's products of the last tile are done
#pragma unroll
    for (int u = 0; u < kWRows * 8 / kWThreads; ++u) {
      const int i = u * kWThreads + threadIdx.x;
      const int r = i / 8, c = i % 8;  // position q0 + r, state columns n0 + 8 c ..
      const int q = q0 + r, n = n0 + 8 * c;
      uint4 hi = make_uint4(0u, 0u, 0u, 0u), lo = hi;
      if (q < Q && n < N) {
        const uint4 b = __ldg(reinterpret_cast<const uint4*>(Bm + (size_t)q * N + n));
        const uint32_t bw[4] = {b.x, b.y, b.z, b.w};
        uint32_t h[4], l[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bw[k]));
          // B * (decay_out * dt), the reference kernel's order
          split_bf16(__fmul_rn(f.x, w[q]), __fmul_rn(f.y, w[q]), h[k], l[k]);
        }
        hi = make_uint4(h[0], h[1], h[2], h[3]);
        lo = make_uint4(l[0], l[1], l[2], l[3]);
      }
      *reinterpret_cast<uint4*>(Hs + sw128_offset(r, c, kWRows)) = hi;
      *reinterpret_cast<uint4*>(Ls + sw128_offset(r, c, kWRows)) = lo;
    }
    load_sw128(Xs, x, Q, P, q0);
    fence_proxy_async();
    __syncthreads();

    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t xd = desc_b128(Xs + 2048 * kk, kWBox, 1024);
      mma_ss_t<P>(acc, desc_b128(Hs + 2048 * kk, kWBox, 1024), xd);
      mma_ss_t<P>(acc, desc_b128(Ls + 2048 * kk, kWBox, 1024), xd);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  const int nr = n0 + 16 * warp + lane / 4;  // and nr + 8
#pragma unroll
  for (int i = 0; i < P / 2; i += 2) {
    const int n = nr + 8 * ((i / 2) % 2);
    if (n < N)
      *reinterpret_cast<float2*>(st + (size_t)n * P + 8 * (i / 4) + 2 * (lane % 4)) =
          make_float2(acc[i], acc[i + 1]);
  }
}

// Grid as ssd_chunk_kernel's; one warpgroup a block.
template <int P>
__global__ void __launch_bounds__(kWThreads)
    ssd_chunk_wgmma_kernel(const __nv_bfloat16* __restrict__ X, const float* __restrict__ DT,
                     const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
                     const __nv_bfloat16* __restrict__ Cm, float* __restrict__ Y,
                     float* __restrict__ ST, int S, int Q, int N, int heads, int n_row) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* cum = reinterpret_cast<float*>(base);  // [kMaxChunk]
  float* aux = cum + kMaxChunk;                 // [kMaxChunk]: dt, or the state weights
  uint8_t* work = base + 2 * kMaxChunk * sizeof(float);  // 1024-aligned
  const int n_c = S / Q;
  const int bh = blockIdx.x / n_c, c = blockIdx.x % n_c;
  const size_t row0 = (size_t)bh * S + (size_t)c * Q;           // x, dt, y rows
  const size_t bc0 = (size_t)(bh / heads) * S + (size_t)c * Q;  // B, C rows

  for (int q = threadIdx.x; q < Q; q += kWThreads) aux[q] = DT[row0 + q];
  __syncthreads();
  chunk_cum_scan(cum, aux, A[bh], Q);
  __syncthreads();

  const int role = blockIdx.y;
  if (role < n_row) {
    const int rt = n_row - 1 - role;  // the longest row tiles first
    y_block_wgmma<P>(X + row0 * P, Bm + bc0 * N, Cm + bc0 * N, Y + row0 * P, cum, aux, work, Q,
                     N, rt * kWRows);
  } else {
    const float last = cum[Q - 1];
    for (int q = threadIdx.x; q < Q; q += kWThreads)
      aux[q] = __fmul_rn(expf(__fsub_rn(last, cum[q])), aux[q]);
    __syncthreads();
    state_block_wgmma<P>(X + row0 * P, Bm + bc0 * N,
                         ST + ((size_t)bh * n_c + c) * (size_t)N * P, aux, work, Q, N,
                         (role - n_row) * kWRows);
  }
}

template <int P>
cudaError_t run_wgmma(const void* x, const void* dt, const void* A, const void* B, const void* C,
                      void* y, void* st, int BH, int S, int Q, int N, int heads,
                      cudaStream_t stream) {
  // 16-byte loads: aligned bases; rows of N and P bf16 are 16-byte multiples
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(B) |
       reinterpret_cast<uintptr_t>(C)) % 16)
    return cudaErrorInvalidValue;
  auto kernel = ssd_chunk_wgmma_kernel<P>;
  const int smem = wgmma_smem_bytes(N);
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int n_row = (Q + kWRows - 1) / kWRows;
  const int n_state = (N + kWRows - 1) / kWRows;
  dim3 grid((unsigned)BH * (unsigned)(S / Q), n_row + n_state);
  kernel<<<grid, kWThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(B),
      static_cast<const __nv_bfloat16*>(C), static_cast<float*>(y), static_cast<float*>(st), S, Q,
      N, heads, n_row);
  return cudaGetLastError();
}

}  // namespace repro

extern "C" {

// x_bf16: x, B and C are bf16 (1) or fp32 (0).  B and C are [BH/heads,
// S, N].  kind 0 (simt): head dims P of 16, 32 and 64 are compiled;
// kind 2 (wgmma): bf16 only, P of 32 and 64, N a multiple of 16 up to
// 256, x, B and C 16-byte aligned.
int ssd_chunk_fwd(const void* x, const void* dt, const void* A, const void* B, const void* C,
                  void* y, void* states, int x_bf16, int BH, int S, int Q, int N, int P,
                  int heads, int kind, void* stream) {
  if (Q < 1 || Q > repro::kMaxChunk || S % Q != 0 || N < 1 || heads < 1 || BH % heads != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 2) {
    if (!x_bf16 || N % 16 != 0 || N > repro::kWMaxState) return cudaErrorInvalidValue;
    if (P == 64) return repro::run_wgmma<64>(x, dt, A, B, C, y, states, BH, S, Q, N, heads, s);
    if (P == 32) return repro::run_wgmma<32>(x, dt, A, B, C, y, states, BH, S, Q, N, heads, s);
    return cudaErrorInvalidValue;
  }
  if (kind != 0) return cudaErrorInvalidValue;
  if (x_bf16)
    return repro::dispatch<__nv_bfloat16>(P, x, dt, A, B, C, y, states, BH, S, Q, N, heads, s);
  return repro::dispatch<float>(P, x, dt, A, B, C, y, states, BH, S, Q, N, heads, s);
}

// Shared memory of one launch of `kind` (0 simt, 2 wgmma) with state size
// N and head dim P.
int ssd_chunk_smem_bytes(int N, int P, int kind) {
  return kind == 2 ? repro::wgmma_smem_bytes(N) : repro::smem_bytes(N, P);
}

}  // extern "C"
