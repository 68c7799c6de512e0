// ssd_chunk_bwd for Hopper (sm_90a): the gradient of ssd_chunk (the
// intra-chunk part of Mamba2's SSD scan, csrc/ssd_chunk.cu).  For each
// (b*h, chunk) of Q positions, with cum, L and the state decay
// e_j = exp(cum_{Q-1} - cum_j) recomputed from dt and A as the forward
// does, and gy [Q, P], gS [N, P] the gradients of y_diag and the chunk
// state:
//
//   CB_ij = C_i . B_j,  G_ij = gy_i . x_j            (i >= j)
//   dx_j  = sum_{i>=j} CB_ij L_ij dt_j gy_i + e_j dt_j (B_j gS)
//   dC_i  = sum_{j<=i} W_ij B_j,   W_ij = G_ij L_ij dt_j
//   dB_j  = sum_{i>=j} W_ij C_i + e_j dt_j (gS x_j)
//   ddt_j = sum_{i>=j} G_ij CB_ij L_ij + e_j s_j,  s_j = B_j^T gS x_j
//   dcum_i += sum_j R_ij,  dcum_j -= sum_i R_ij,   R_ij = G_ij CB_ij L_ij dt_j
//   dcum_{Q-1} += sum_q e_q dt_q s_q,  dcum_q -= e_q dt_q s_q
//
// then, through cum = cumsum(-dt * A): rc = the reverse cumsum of dcum
// within the chunk, ddt += -A rc and dA = -sum dt rc.
//
// The reference has no backward kernel: its training path differentiates
// the einsum form of ssd (src/repro/models/ssm.py::ssd) with JAX's
// autodiff, and its Pallas kernel src/repro/kernels/ssd_scan.py::ssd_chunk
// (:49, pallas_call at :62) has no custom_vjp.  The port's ssd runs the
// forward kernel on every path, so its gradient is this kernel, bound
// through kernels/ssd_scan.py::SsdChunk.
//
// Two kinds, one launch each, as the forward's (kernels/ssd_scan.py
// routes a call by kssd.wgmma_takes, the forward's rule):
//
// simt (every fp32 call): split over thread blocks as the forward's simt
// kind is: a chunk's [Q x Q] tiles do not fit one block, so one launch
// runs three roles per (b*h, chunk), over 64-row tiles, each visiting
// only the tiles i >= j:
//
//   * column blocks (one per 64-column tile j): CB and G tiles in
//     registers, L formed only where i >= j; dx_j accumulates in
//     registers over the row tiles, the column sums of G o CB o L (for
//     ddt and dcum) go through shared memory, and each tile's row sums of
//     R are written as that column tile's partial of dcum_i.  After the
//     row tiles: u = B_j gS, the state terms of dx_j, ddt_j and dcum.
//   * dB blocks (column tile j, 64 state columns n): W_ij^T C_i over the
//     row tiles, then e_j dt_j (gS x_j).  dB is written per head.
//   * dC blocks (row tile i, 64 state columns n): W_ij B_j over the
//     column tiles j <= i.  dC is written per head.
//
// Plain fp32 FMA from shared memory; x, B and C are read as bf16 or fp32.
// cum is recomputed by one thread in order 0..Q-1 with the forward simt
// kind's rounding.  P is 16, 32 or 64 (compiled), N any value up to 256
// that fits the column block's shared memory.  It keeps the fp32
// contracts (the 2-layer fp32 gradients against the plain control,
// remat on == off bitwise) as they were.
//
// wgmma (bf16 x, B, C with N a multiple of 16 up to 256 and P 32 or 64):
// the tile products on the tensor cores, one warpgroup (128 threads) a
// block.  x, B and C are bf16 and exact as operands; gy and gS are fp32,
// each split once, as its tile is loaded, into hi = bf16(v) and
// lo = bf16(v - hi); the fp32 weights formed on the accumulator fragments,
// M = CB o L o dt_j and W = G o L o dt_j, are split alike, and every
// product of halves goes into one fp32 accumulator (about 16 bits kept,
// as the forward's wgmma kind keeps them).  Chains a product: C B^T one;
// G two (gy hi, lo); dx += M^T gy three (hi hi, hi lo, lo hi); dB += W^T C
// and dC += W B two; u = B gS and v = x gS^T two.  Tiles are bf16 in
// 64-row, 128-byte-swizzled boxes written by the block's threads: one
// tile serves K-major (C B^T's and G's operands) and MN-major (the B
// operand of dx, dB and dC: the transpose bit), so nothing is transposed
// scalar by scalar.  cum is the forward wgmma kind's warp scan
// (ssd_common.cuh), so the backward differentiates the L the forward used.
// Three roles a (group of heads, chunk), heaviest first:
//
//   * dx blocks (column tile j): for each row tile i >= j, CB^T and G^T
//     [j x i], M^T and T = G o CB o L on the fragments, dx_j += M^T gy_i;
//     the row sums of T (ddt_j) by quad shuffles, the column sums of
//     R = T dt_j (dcum_i) by shuffles and shared memory, each in one
//     fixed order.  Then u = B_j gS: dx_j's state term, s_j, ddt_j, dcum.
//   * dB blocks (column tile j, a state slice of 64 or 128 columns):
//     G^T, W^T on the fragments, dB_j += W^T C_i; then v = x_j gS^T.
//   * dC blocks (row tile i, a state slice): G, W, dC_i += W B_j over
//     j <= i.
//
// G is formed three times a tile pair (the simt kind five times) and CB
// once.  One column role carrying dx and dB together would form G twice,
// but would hold three accumulators and two score tiles at once; split,
// each role holds one output accumulator and the three carry about equal
// work.  Even so each role takes 180-210 registers a thread at P 64 and
// N 128 when compiled alone (ptxas; the kernel 216), so two blocks share
// an SM (__launch_bounds__(128, 2)); bounding them to three (168
// registers) spills.  The tiles come by cp.async (16 bytes a copy, no
// register, all of a tile in flight at once, zero-filled past Q); gy and
// gS, which are split on the way, by 32-byte register loads, four in
// flight a thread.  B and C are shared by the heads of a batch row: a
// block loops over a group of heads (kssd's BWD_HEAD_GROUP, 4 at mamba2's
// 32 heads) in head order and sums their dB (dC) into one accumulator, so
// the per-group slabs are a quarter of the per-head ones and the torch
// pass sums only the groups.  Shared memory a block: 1,024 bytes of
// alignment, the cum, dt and e stripes and the reduction rows (4,096),
// then B_j (N boxes), x_j, and C_i, gy_i hi and lo (later gS hi and lo):
// 62,464 bytes at N 128, 111,616 at N 256.
//
// No atomics in either kind: every sum runs in one fixed order inside its
// block, so a repeat is bitwise equal.  What crosses blocks goes through
// device memory and a small fixed-order torch pass after the launch
// (kernels/ssd_scan.py::_launch_bwd): the sum of the column tiles' dcum
// partials, the states' dcum_{Q-1} term, the reverse cumsum, the -A rc
// term of ddt, the dA reduction over the chunks, and the sum of dB and dC
// over the heads (simt) or groups of heads (wgmma) that share a row of B
// and C.  Q is a runtime value from 1 to 256; ragged row, column and
// state tiles are masked.
//
// Bound on the H100: at mamba2-370m's training shape (B 8, 32 heads,
// S 1024, P 64, N 128, Q 256) one call reads x, B, C (bf16), gy and gS
// and writes dx, ddt, dB, dC and dA (fp32), 0.22 GB, 0.065 ms at
// 3.35 TB/s, against ~43 GFLOP (chip_smoke.py::ssd_bwd_work), 0.044 ms
// at the bf16 tensor-core peak: bound by bytes.  The wgmma kind's hi / lo
// chains, G's recomputation and whole diagonal tiles take it to ~119
// GFLOP of tensor work (0.12 ms at the peak).
//
// Plain C interface for ctypes: ssd_chunk_bwd returns the CUDA error of
// the launch (0 on success); ssd_chunk_bwd_smem_bytes gives the shared
// memory of a launch of a kind, which kernels/ssd_scan.py::bwd_smem_bytes
// mirrors.
#include <cstdint>

#include "ssd_common.cuh"
#include "tile_common.cuh"

namespace repro {

constexpr int kMaxChunk = 256;   // longest chunk
constexpr int kT = 64;           // rows and columns of a tile
constexpr int kLd = kT + 1;      // padded row stride of a [.][64] tile
constexpr int kTM = 4, kTN = 4;  // register tile of a [64 x 64] product
constexpr int kNT = kT / kTN;    // 16 threads across columns (and rows)
constexpr int kThreads = kNT * kNT;

// Shared memory, in floats, after the three [kMaxChunk] stripes (cum, dt
// and e).  The column block's: B_j^T and C_i^T [N][65] (C's reused for
// gS), x_j^T and gy_i^T [P][65], gy_i [64][P], and the W and T tiles
// [64][65].  The dB and dC blocks need less.
__host__ __device__ constexpr int col_floats(int N, int P) {
  return 2 * N * kLd + 2 * P * kLd + kT * P + 2 * kT * kLd;
}
__host__ __device__ constexpr int bc_floats(int P) {
  return 2 * P * kLd + kT * kLd + kT * kT + P * kT;
}
__host__ __device__ constexpr int bwd_smem_bytes(int N, int P) {
  return (int)sizeof(float) *
         (3 * kMaxChunk + (col_floats(N, P) > bc_floats(P) ? col_floats(N, P) : bc_floats(P)));
}

// Rows [r0, r0 + 64) of a [Q x W] row-major slab (row stride `ld`, first
// column c0, W columns taken) into shared memory as fp32, zero past row Q
// and past column W.  TRANSPOSE stores dst[c * dst_ld + r], else
// dst[r * dst_ld + c].
template <typename T, bool TRANSPOSE>
__device__ __forceinline__ void load_rows(float* dst, int dst_ld, const T* __restrict__ src,
                                          int ld, int Q, int r0, int c0, int W, int cols) {
  for (int idx = threadIdx.x; idx < kT * cols; idx += kThreads) {
    const int r = idx / cols, c = idx % cols;
    const int q = r0 + r;
    const float v = (q < Q && c0 + c < W) ? to_f32(src[(size_t)q * ld + c0 + c]) : 0.f;
    if (TRANSPOSE) {
      dst[c * dst_ld + r] = v;
    } else {
      dst[r * dst_ld + c] = v;
    }
  }
}

// The [64 x 64] score tile s[a][b] = sum over n < N of Ts[n][row] *
// Us[n][col] (both [N][65], n-major), rows ty + 16a, columns tx + 16b.
__device__ __forceinline__ void score_tile(float (&s)[kTM][kTN], const float* Ts,
                                           const float* Us, int N, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < kTM; ++a)
#pragma unroll
    for (int b = 0; b < kTN; ++b) s[a][b] = 0.f;
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    float u[kTM], v[kTN];
#pragma unroll
    for (int a = 0; a < kTM; ++a) u[a] = Ts[n * kLd + ty + a * kNT];
#pragma unroll
    for (int b = 0; b < kTN; ++b) v[b] = Us[n * kLd + tx + b * kNT];
#pragma unroll
    for (int a = 0; a < kTM; ++a)
#pragma unroll
      for (int b = 0; b < kTN; ++b) s[a][b] = fmaf(u[a], v[b], s[a][b]);
  }
}

template <int TO>
__device__ __forceinline__ void zero(float (&acc)[kTM][TO]) {
#pragma unroll
  for (int a = 0; a < kTM; ++a)
#pragma unroll
    for (int c = 0; c < TO; ++c) acc[a][c] = 0.f;
}

// Column tile [j0, j0 + 64): dx_j, the direct ddt_j, its dcum terms and,
// per row tile, the partial row sums of R.
template <typename T, int P>
__device__ __forceinline__ void col_block(const T* __restrict__ x, const T* __restrict__ Bm,
                                          const T* __restrict__ Cm, const float* __restrict__ gy,
                                          const float* __restrict__ gS, float* __restrict__ dx,
                                          float* __restrict__ ddt, float* __restrict__ dcum,
                                          float* __restrict__ rowpart, const float* cum,
                                          const float* dt, const float* e, float* work, int Q,
                                          int N, int j0) {
  constexpr int TO = P / kNT;
  float* Bs = work;              // [N][65]: B_j^T
  float* Cs = Bs + N * kLd;      // [N][65]: C_i^T; later gS [N][P]
  float* Xt = Cs + N * kLd;      // [P][65]: x_j^T
  float* Gt = Xt + P * kLd;      // [P][65]: gy_i^T
  float* Gy = Gt + P * kLd;      // [64][P]: gy_i
  float* Ws = Gy + kT * P;       // [64][65]: CB o L o dt_j, [i][j]
  float* Ts = Ws + kT * kLd;     // [64][65]: G o CB o L, [i][j]
  const int tx = threadIdx.x % kNT, ty = threadIdx.x / kNT;
  load_rows<T, true>(Bs, kLd, Bm, N, Q, j0, 0, N, N);
  load_rows<T, true>(Xt, kLd, x, P, Q, j0, 0, P, P);

  float acc[kTM][TO];
  zero(acc);
  float tcol = 0.f;  // thread t < 64: sum over i of T[i][j0 + t]
  for (int i0 = j0; i0 < Q; i0 += kT) {
    load_rows<T, true>(Cs, kLd, Cm, N, Q, i0, 0, N, N);
    load_rows<float, true>(Gt, kLd, gy, P, Q, i0, 0, P, P);
    load_rows<float, false>(Gy, P, gy, P, Q, i0, 0, P, P);
    __syncthreads();
    float cb[kTM][kTN], g[kTM][kTN];
    score_tile(cb, Cs, Bs, N, ty, tx);
    zero(g);
    fma_tile<kT, kT, kTM, kTN, P>(g, Gt, kLd, Xt, kLd, ty, tx);
#pragma unroll
    for (int a = 0; a < kTM; ++a) {
      const int r = ty + a * kNT, gi = i0 + r;
#pragma unroll
      for (int b = 0; b < kTN; ++b) {
        const int c = tx + b * kNT, gj = j0 + c;
        float w = 0.f, t = 0.f;
        if (gj <= gi && gi < Q) {
          const float L = expf(__fsub_rn(cum[gi], cum[gj]));
          const float cl = __fmul_rn(cb[a][b], L);
          w = __fmul_rn(cl, dt[gj]);
          t = __fmul_rn(g[a][b], cl);
        }
        Ws[r * kLd + c] = w;
        Ts[r * kLd + c] = t;
      }
    }
    __syncthreads();
    fma_tile<kT, P, kTM, TO, kT>(acc, Ws, kLd, Gy, P, ty, tx);
    if (threadIdx.x < kT) {
      for (int r = 0; r < kT; ++r) tcol = __fadd_rn(tcol, Ts[r * kLd + threadIdx.x]);
    } else if (threadIdx.x < 2 * kT) {
      const int r = threadIdx.x - kT;
      float rs = 0.f;
      for (int c = 0; c < kT; ++c) rs = __fadd_rn(rs, __fmul_rn(Ts[r * kLd + c], dt[j0 + c]));
      if (i0 + r < Q) rowpart[i0 + r] = rs;
    }
    __syncthreads();
  }

  // the state terms: u_j = B_j gS [P], then s_j = u_j . x_j
  for (int idx = threadIdx.x; idx < N * P; idx += kThreads) Cs[idx] = gS[idx];  // [N][P]
  __syncthreads();
  float u[kTM][TO];
  zero(u);
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    float bj[kTM], gs[TO];
#pragma unroll
    for (int a = 0; a < kTM; ++a) bj[a] = Bs[n * kLd + ty + a * kNT];
#pragma unroll
    for (int c = 0; c < TO; ++c) gs[c] = Cs[n * P + tx + c * kNT];
#pragma unroll
    for (int a = 0; a < kTM; ++a)
#pragma unroll
      for (int c = 0; c < TO; ++c) u[a][c] = fmaf(bj[a], gs[c], u[a][c]);
  }
#pragma unroll
  for (int a = 0; a < kTM; ++a) {
    const int r = ty + a * kNT, gj = j0 + r;
    const float ed = __fmul_rn(e[gj], dt[gj]);
#pragma unroll
    for (int c = 0; c < TO; ++c) {
      const int p = tx + c * kNT;
      Gy[r * P + p] = u[a][c];
      if (gj < Q) dx[(size_t)gj * P + p] = fmaf(ed, u[a][c], acc[a][c]);
    }
  }
  __syncthreads();
  if (threadIdx.x < kT) {
    const int r = threadIdx.x, gj = j0 + r;
    if (gj < Q) {
      float s = 0.f;
      for (int p = 0; p < P; ++p) s = fmaf(Gy[r * P + p], Xt[p * kLd + r], s);
      const float sterm = __fmul_rn(__fmul_rn(e[gj], dt[gj]), s);
      ddt[gj] = fmaf(e[gj], s, tcol);
      dcum[gj] = __fsub_rn(-__fmul_rn(dt[gj], tcol), sterm);
      dcum[Q + gj] = sterm;  // the states' term, summed into dcum_{Q-1} after the launch
    }
  }
}

// dB for the column tile [j0, j0 + 64) and state columns [n0, n0 + 64):
// sum over i >= j of W_ij C_i, then e_j dt_j (gS x_j).
template <typename T, int P>
__device__ __forceinline__ void db_block(const T* __restrict__ x, const T* __restrict__ Cm,
                                         const float* __restrict__ gy,
                                         const float* __restrict__ gS, float* __restrict__ dB,
                                         const float* cum, const float* dt, const float* e,
                                         float* work, int Q, int N, int j0, int n0) {
  float* Xt = work;              // [P][65]: x_j^T
  float* Gt = Xt + P * kLd;      // [P][65]: gy_i^T
  float* Ws = Gt + P * kLd;      // [64][65]: W, [i][j]
  float* Cn = Ws + kT * kLd;     // [64][64]: C_i, columns n0..
  float* St = Cn + kT * kT;      // [P][64]: gS^T, columns n0..
  const int tx = threadIdx.x % kNT, ty = threadIdx.x / kNT;
  load_rows<T, true>(Xt, kLd, x, P, Q, j0, 0, P, P);

  float acc[kTM][kTN];
  zero(acc);
  for (int i0 = j0; i0 < Q; i0 += kT) {
    load_rows<float, true>(Gt, kLd, gy, P, Q, i0, 0, P, P);
    load_rows<T, false>(Cn, kT, Cm, N, Q, i0, n0, N, kT);
    __syncthreads();
    float g[kTM][kTN];
    zero(g);
    fma_tile<kT, kT, kTM, kTN, P>(g, Gt, kLd, Xt, kLd, ty, tx);
#pragma unroll
    for (int a = 0; a < kTM; ++a) {
      const int r = ty + a * kNT, gi = i0 + r;
#pragma unroll
      for (int b = 0; b < kTN; ++b) {
        const int c = tx + b * kNT, gj = j0 + c;
        float w = 0.f;
        if (gj <= gi && gi < Q)
          w = __fmul_rn(__fmul_rn(g[a][b], expf(__fsub_rn(cum[gi], cum[gj]))), dt[gj]);
        Ws[r * kLd + c] = w;
      }
    }
    __syncthreads();
    fma_tile<kT, kT, kTM, kTN, kT>(acc, Ws, kLd, Cn, kT, ty, tx);
    __syncthreads();
  }

  // gS^T for columns n0..: St[p][n] = gS[n0 + n][p]
  for (int idx = threadIdx.x; idx < kT * P; idx += kThreads) {
    const int n = idx / P, p = idx % P;
    St[p * kT + n] = n0 + n < N ? gS[(size_t)(n0 + n) * P + p] : 0.f;
  }
  __syncthreads();
  float v[kTM][kTN];
  zero(v);
  fma_tile<kT, kT, kTM, kTN, P>(v, Xt, kLd, St, kT, ty, tx);
#pragma unroll
  for (int a = 0; a < kTM; ++a) {
    const int gj = j0 + ty + a * kNT;
    if (gj >= Q) continue;
    const float ed = __fmul_rn(e[gj], dt[gj]);
#pragma unroll
    for (int b = 0; b < kTN; ++b) {
      const int n = n0 + tx + b * kNT;
      if (n < N) dB[(size_t)gj * N + n] = fmaf(ed, v[a][b], acc[a][b]);
    }
  }
}

// dC for the row tile [i0, i0 + 64) and state columns [n0, n0 + 64):
// sum over j <= i of W_ij B_j.
template <typename T, int P>
__device__ __forceinline__ void dc_block(const T* __restrict__ x, const T* __restrict__ Bm,
                                         const float* __restrict__ gy, float* __restrict__ dC,
                                         const float* cum, const float* dt, float* work, int Q,
                                         int N, int i0, int n0) {
  float* Gt = work;              // [P][65]: gy_i^T
  float* Xt = Gt + P * kLd;      // [P][65]: x_j^T
  float* Wt = Xt + P * kLd;      // [64][65]: W^T, [j][i]
  float* Bn = Wt + kT * kLd;     // [64][64]: B_j, columns n0..
  const int tx = threadIdx.x % kNT, ty = threadIdx.x / kNT;
  load_rows<float, true>(Gt, kLd, gy, P, Q, i0, 0, P, P);

  float acc[kTM][kTN];
  zero(acc);
  for (int j0 = 0; j0 <= i0; j0 += kT) {
    load_rows<T, true>(Xt, kLd, x, P, Q, j0, 0, P, P);
    load_rows<T, false>(Bn, kT, Bm, N, Q, j0, n0, N, kT);
    __syncthreads();
    float g[kTM][kTN];
    zero(g);
    fma_tile<kT, kT, kTM, kTN, P>(g, Gt, kLd, Xt, kLd, ty, tx);
#pragma unroll
    for (int a = 0; a < kTM; ++a) {
      const int r = ty + a * kNT, gi = i0 + r;
#pragma unroll
      for (int b = 0; b < kTN; ++b) {
        const int c = tx + b * kNT, gj = j0 + c;
        float w = 0.f;
        if (gj <= gi && gi < Q)
          w = __fmul_rn(__fmul_rn(g[a][b], expf(__fsub_rn(cum[gi], cum[gj]))), dt[gj]);
        Wt[c * kLd + r] = w;
      }
    }
    __syncthreads();
    fma_tile<kT, kT, kTM, kTN, kT>(acc, Wt, kLd, Bn, kT, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < kTM; ++a) {
    const int gi = i0 + ty + a * kNT;
    if (gi >= Q) continue;
#pragma unroll
    for (int b = 0; b < kTN; ++b) {
      const int n = n0 + tx + b * kNT;
      if (n < N) dC[(size_t)gi * N + n] = acc[a][b];
    }
  }
}

// Grid: x = b*h * n_c + chunk; y = role: n_t column blocks, then n_t * n_n
// dB blocks, then n_t * n_n dC blocks (n_t row / column tiles, n_n state
// column tiles).
template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_bwd_kernel(const T* __restrict__ X, const float* __restrict__ DT,
                         const float* __restrict__ A, const T* __restrict__ Bm,
                         const T* __restrict__ Cm, const float* __restrict__ GY,
                         const float* __restrict__ GS, float* __restrict__ DX,
                         float* __restrict__ DDT, float* __restrict__ DCUM,
                         float* __restrict__ ROWPART, float* __restrict__ DB,
                         float* __restrict__ DC, int S, int Q, int N, int heads) {
  extern __shared__ float smem[];
  float* cum = smem;                   // [kMaxChunk]
  float* dt = smem + kMaxChunk;        // [kMaxChunk], 0 past Q
  float* e = smem + 2 * kMaxChunk;     // [kMaxChunk]: exp(cum_{Q-1} - cum)
  float* work = smem + 3 * kMaxChunk;
  const int n_c = S / Q, n_t = (Q + kT - 1) / kT, n_n = (N + kT - 1) / kT;
  const int bh = blockIdx.x / n_c, c = blockIdx.x % n_c;
  const size_t row0 = (size_t)bh * S + (size_t)c * Q;           // x, dt, gy, dx rows
  const size_t bc0 = (size_t)(bh / heads) * S + (size_t)c * Q;  // B, C rows
  const size_t st0 = ((size_t)bh * n_c + c) * (size_t)N * P;     // gS

  for (int q = threadIdx.x; q < kMaxChunk; q += kThreads) dt[q] = q < Q ? DT[row0 + q] : 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    const float a = A[bh];
    float run = 0.f;
    for (int q = 0; q < Q; ++q) {
      run = __fadd_rn(run, __fmul_rn(-dt[q], a));
      cum[q] = run;
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < kMaxChunk; q += kThreads)
    e[q] = q < Q ? expf(__fsub_rn(cum[Q - 1], cum[q])) : 0.f;
  __syncthreads();

  int role = blockIdx.y;
  if (role < n_t) {
    // DCUM holds, per chunk, the column terms [Q] then the states' terms
    // [Q]; ROWPART one row of S per column tile
    col_block<T, P>(X + row0 * P, Bm + bc0 * N, Cm + bc0 * N, GY + row0 * P, GS + st0,
                    DX + row0 * P, DDT + row0, DCUM + ((size_t)bh * n_c + c) * 2 * Q,
                    ROWPART + ((size_t)bh * n_t + role) * S + (size_t)c * Q, cum, dt, e, work, Q,
                    N, role * kT);
    return;
  }
  role -= n_t;
  if (role < n_t * n_n) {
    db_block<T, P>(X + row0 * P, Cm + bc0 * N, GY + row0 * P, GS + st0, DB + row0 * N, cum, dt,
                   e, work, Q, N, (role / n_n) * kT, (role % n_n) * kT);
    return;
  }
  role -= n_t * n_n;
  dc_block<T, P>(X + row0 * P, Bm + bc0 * N, GY + row0 * P, DC + row0 * N, cum, dt, work, Q, N,
                 (n_t - 1 - role / n_n) * kT, (role % n_n) * kT);
}

template <typename T, int P>
cudaError_t run_bwd(const void* x, const void* dt, const void* A, const void* B, const void* C,
                    const void* gy, const void* gS, void* dx, void* ddt, void* dcum,
                    void* rowpart, void* dB, void* dC, int BH, int S, int Q, int N, int heads,
                    cudaStream_t stream) {
  auto kernel = ssd_chunk_bwd_kernel<T, P>;
  const int smem = bwd_smem_bytes(N, P);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_t = (Q + kT - 1) / kT, n_n = (N + kT - 1) / kT;
  dim3 grid((unsigned)BH * (unsigned)(S / Q), n_t + 2 * n_t * n_n);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<const float*>(gy),
      static_cast<const float*>(gS), static_cast<float*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dcum), static_cast<float*>(rowpart), static_cast<float*>(dB),
      static_cast<float*>(dC), S, Q, N, heads);
  return cudaGetLastError();
}

template <typename T>
int dispatch_bwd(int P, const void* x, const void* dt, const void* A, const void* B,
                 const void* C, const void* gy, const void* gS, void* dx, void* ddt, void* dcum,
                 void* rowpart, void* dB, void* dC, int BH, int S, int Q, int N, int heads,
                 cudaStream_t s) {
  switch (P) {
    case 16:
      return run_bwd<T, 16>(x, dt, A, B, C, gy, gS, dx, ddt, dcum, rowpart, dB, dC, BH, S, Q, N,
                            heads, s);
    case 32:
      return run_bwd<T, 32>(x, dt, A, B, C, gy, gS, dx, ddt, dcum, rowpart, dB, dC, BH, S, Q, N,
                            heads, s);
    case 64:
      return run_bwd<T, 64>(x, dt, A, B, C, gy, gS, dx, ddt, dcum, rowpart, dB, dC, BH, S, Q, N,
                            heads, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- wgmma --
constexpr int kWMaxState = 256;
// The stripes (cum, dt, e) and the dx role's reduction rows (one row of
// 64 column sums a warp), fp32.
constexpr int kWStripeBytes = (3 * kMaxChunk + 4 * kWRows) * (int)sizeof(float);

// State columns a dB or dC block accumulates: 64 up to N 64, else 128.
__host__ __device__ constexpr int w_slice(int N) { return N <= 64 ? 64 : 128; }
// 64-column boxes of a [64 x N] state tile, N rounded up to whole slices.
__host__ __device__ constexpr int w_state_boxes(int N) {
  return (N + w_slice(N) - 1) / w_slice(N) * (w_slice(N) / 64);
}
// Alignment, the stripes, B_j and x_j, then C_i and gy_i's hi and lo, or
// (after the row tiles) gS's hi and lo, whichever is larger.
__host__ __device__ constexpr int wgmma_bwd_smem_bytes(int N) {
  return 1024 + kWStripeBytes +
         (w_state_boxes(N) + 1 +
          (w_state_boxes(N) + 2 > 2 * w_state_boxes(N) ? w_state_boxes(N) + 2
                                                        : 2 * w_state_boxes(N))) *
             kWBox;
}

struct BwdArgs {
  const __nv_bfloat16* x;  // [BH, S, P]
  const __nv_bfloat16* B;  // [BH / heads, S, N]
  const __nv_bfloat16* C;
  const float* dt;         // [BH, S]
  const float* A;          // [BH]
  const float* gy;         // [BH, S, P]
  const float* gS;         // [BH, S / Q, N, P]
  float* dx;
  float* ddt;
  float* dcum;
  float* rowpart;
  float* dB;               // [BH / group, S, N]
  float* dC;
  int S, Q, N, heads, group;
};

// 16 bytes from global to shared memory without a register, zeros where
// !valid (src is then not read); cp_async_wait waits for this thread's.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// The block's tiles are written: this thread's copies landed, ordered
// before the tensor cores' reads (async proxy), every thread's likewise.
__device__ __forceinline__ void tiles_ready() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  fence_proxy_async();
  __syncthreads();
}

// Rows [r0, r0 + 64) and columns [c0, c0 + cols) of a row-major bf16 slab
// (row stride ld; cols and ld multiples of 8) into 64-row boxes, 128-byte
// swizzled, zero past row `valid`: 16-byte asynchronous copies, all in
// flight at once (tiles_ready waits for them).
__device__ __forceinline__ void load_bf16_sw(uint8_t* dst, const __nv_bfloat16* __restrict__ src,
                                             int ld, int valid, int r0, int c0, int cols) {
  const int cpr = cols / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < kWRows * cpr; i += kWThreads) {
    const int r = i / cpr, cc = i % cpr;
    const bool ok = r0 + r < valid;
    cp_async16(dst + sw128_offset(r, cc, kWRows), src + (size_t)(ok ? r0 + r : 0) * ld + c0 + 8 * cc,
               ok);
  }
}

// Eight fp32 values as bf16 hi and lo halves, into 16-byte chunk `off`
// of two swizzled tiles.
__device__ __forceinline__ void store_split(uint8_t* hi, uint8_t* lo, int off, float4 a,
                                            float4 b) {
  uint32_t h[4], l[4];
  split_bf16(a.x, a.y, h[0], l[0]);
  split_bf16(a.z, a.w, h[1], l[1]);
  split_bf16(b.x, b.y, h[2], l[2]);
  split_bf16(b.z, b.w, h[3], l[3]);
  *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
}

// Rows [r0, r0 + rows) of a row-major fp32 slab of `cols` columns (a
// multiple of 8, at most 64: one box wide, any number of rows) as two
// swizzled bf16 tiles, hi and lo, zero past row `valid`.  Four 32-byte
// chunks in flight a thread.
__device__ __forceinline__ void load_split_sw(uint8_t* hi, uint8_t* lo, const float* __restrict__ src,
                                              int valid, int r0, int rows, int cols) {
  const int cpr = cols / 8;
  const int total = rows * cpr;
  for (int base = 0; base < total; base += 4 * kWThreads) {
    float4 v[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * kWThreads + threadIdx.x;
      const int r = i / cpr;
      v[u][0] = v[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < total && r0 + r < valid) {
        const float4* p =
            reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * cols + 8 * (i % cpr));
        v[u][0] = __ldg(p);
        v[u][1] = __ldg(p + 1);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * kWThreads + threadIdx.x;
      if (i < total) store_split(hi, lo, sw128_offset(i / cpr, i % cpr, kWRows), v[u][0], v[u][1]);
    }
  }
}

// Accumulator register i of a [64 x n] wgmma tile: its row and column.
__device__ __forceinline__ int frag_row(int i) {
  return 16 * ((int)threadIdx.x / 32) + ((int)threadIdx.x % 32) / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int frag_col(int i) {
  return 8 * (i / 4) + 2 * ((int)threadIdx.x % 4) + i % 2;
}

template <int N>
__device__ __forceinline__ void clear(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// d [64 x 64] += a [64 x k] . b [64 x k]^T, both K-major in 64-wide boxes.
__device__ __forceinline__ void mma_nt(float (&d)[32], const uint8_t* a, const uint8_t* b, int k) {
  for (int kk = 0; kk < k / 16; ++kk) {
    const int off = (kk / 4) * kWBox + 32 * (kk % 4);
    wgmma_m64n64k16_ss<0, 0>(d, desc_b128(a + off, 16, 1024), desc_b128(b + off, 16, 1024));
  }
}

// d [64 x NW] += a (shared, K-major) . b; TB = 1: b MN-major, 0: K-major.
template <int NW, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[NW / 2], uint64_t a, uint64_t b) {
  if constexpr (NW == 128) {
    wgmma_m64n128k16_ss<TB>(d, a, b);
  } else if constexpr (NW == 64) {
    wgmma_m64n64k16_ss<0, TB>(d, a, b);
  } else {
    wgmma_m64n32k16_ss<0, TB>(d, a, b);
  }
}

// d [64 x NW] += a (registers: bf16 pairs) . b (shared, MN-major).
template <int NW>
__device__ __forceinline__ void mma_rs(float (&d)[NW / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (NW == 128) {
    wgmma_m64n128k16_rs<1>(d, a, b);
  } else if constexpr (NW == 64) {
    wgmma_m64n64k16_rs<1>(d, a, b);
  } else {
    wgmma_m64n32k16_rs<1>(d, a, b);
  }
}

// Columns [16 kk, 16 kk + 16) of a [64 x 64] fp32 fragment as wgmma A
// operands: the hi and lo halves.
__device__ __forceinline__ void frag_split(const float (&w)[32], int kk, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) split_bf16(w[8 * kk + 2 * u], w[8 * kk + 2 * u + 1], hi[u], lo[u]);
}

// The MN-major descriptor of rows [16 kk, 16 kk + 16) of a tile.
__device__ __forceinline__ uint64_t mn_desc(const uint8_t* t, int kk) {
  return desc_b128(t + 2048 * kk, kWBox, 1024);
}

// Head bh's stripes for its chunk (row0: the chunk's first row): dt (0
// past Q), cum by the forward's warp scan, e = exp(cum_{Q-1} - cum).
__device__ __forceinline__ void head_stripes(const BwdArgs& a, float* cum, float* dt, float* e,
                                             int bh, size_t row0) {
  __syncthreads();  // the last head's readers are done
  for (int q = threadIdx.x; q < kMaxChunk; q += kWThreads) dt[q] = q < a.Q ? a.dt[row0 + q] : 0.f;
  __syncthreads();
  chunk_cum_scan(cum, dt, a.A[bh], a.Q);
  __syncthreads();
  for (int q = threadIdx.x; q < kMaxChunk; q += kWThreads)
    e[q] = q < a.Q ? expf(__fsub_rn(cum[a.Q - 1], cum[q])) : 0.f;
}

// The dx role, column tile [j0, j0 + 64): per head, dx_j, the direct
// ddt_j, dcum_j's terms and, per row tile, the row partials of dcum_i.
template <int P>
__device__ __forceinline__ void dx_role(const BwdArgs& a, uint8_t* work, float* cum, float* dt,
                                        float* e, float* red, int g, int c, int n_c, int n_t,
                                        int jt) {
  const int Q = a.Q, N = a.N, S = a.S, nb = w_state_boxes(N), j0 = jt * kWRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint8_t* Bs = work;                // B_j [64][N], K-major
  uint8_t* Xs = Bs + nb * kWBox;     // x_j [64][P], K-major
  uint8_t* Cs = Xs + kWBox;          // C_i [64][N], K-major
  uint8_t* Gh = Cs + nb * kWBox;     // gy_i [64][P]: hi, K-major for G^T, MN-major for dx
  uint8_t* Gl = Gh + kWBox;          // and lo
  uint8_t* Sh = Cs;                  // gS [N][P] after the row tiles: hi (MN-major)
  uint8_t* Sl = Sh + nb * kWBox;     // and lo
  const size_t bc0 = (size_t)(g * a.group / a.heads) * S + (size_t)c * Q;
  load_bf16_sw(Bs, a.B + bc0 * N, N, Q, j0, 0, N);

  for (int k = 0; k < a.group; ++k) {
    const int bh = g * a.group + k;
    const size_t row0 = (size_t)bh * S + (size_t)c * Q;
    head_stripes(a, cum, dt, e, bh, row0);
    load_bf16_sw(Xs, a.x + row0 * P, P, Q, j0, 0, P);
    float acc[P / 2];
    clear(acc);
    float tcol[2] = {0.f, 0.f};  // rows r, r + 8: sum over i of T[i][j]
    for (int it = jt; it < n_t; ++it) {
      const int i0 = it * kWRows;
      __syncthreads();  // the last tile's products and reduction rows are done
      load_bf16_sw(Cs, a.C + bc0 * N, N, Q, i0, 0, N);
      load_split_sw(Gh, Gl, a.gy + row0 * P, Q, i0, kWRows, P);
      tiles_ready();

      float cb[32], gt[32];  // C B^T and G^T, [j][i]
      clear(cb);
      clear(gt);
      fence_regs(cb);
      fence_regs(gt);
      wgmma_fence();
      mma_nt(cb, Bs, Cs, N);
      mma_nt(gt, Xs, Gh, P);
      mma_nt(gt, Xs, Gl, P);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(cb);
      fence_regs(gt);

      // M^T = CB o L o dt_j into cb, T = G o CB o L into gt
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int gj = j0 + frag_row(r), gi = i0 + frag_col(r);
        float m = 0.f, t = 0.f;
        if (gj <= gi && gi < Q) {
          const float cl = __fmul_rn(cb[r], expf(__fsub_rn(cum[gi], cum[gj])));
          m = __fmul_rn(cl, dt[gj]);
          t = __fmul_rn(gt[r], cl);
        }
        cb[r] = m;
        gt[r] = t;
      }

      // dx_j += M^T gy_i: hi hi + hi lo + lo hi
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t hi[4], lo[4];
        frag_split(cb, kk, hi, lo);
        mma_rs<P>(acc, hi, mn_desc(Gh, kk));
        mma_rs<P>(acc, hi, mn_desc(Gl, kk));
        mma_rs<P>(acc, lo, mn_desc(Gh, kk));
      }
      wgmma_commit();

      // while the products run, in a fixed order: T's row sums (ddt_j) by
      // quad shuffles; R = T dt_j's column sums (dcum_i) over the thread's
      // two rows, the warp's 16 by shuffles, the four warps' in shared
      // memory
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float rs = 0.f;
#pragma unroll
        for (int m = 0; m < 8; ++m)
          rs = __fadd_rn(__fadd_rn(rs, gt[4 * m + 2 * h]), gt[4 * m + 2 * h + 1]);
        rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, 1));
        rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, 2));
        tcol[h] = __fadd_rn(tcol[h], rs);
      }
      const float dt0 = dt[j0 + frag_row(0)], dt1 = dt[j0 + frag_row(2)];
#pragma unroll
      for (int ci = 0; ci < 16; ++ci) {
        const int r = 4 * (ci / 2) + ci % 2;  // rows r0 (register r) and r0 + 8 (r + 2)
        float cs = __fadd_rn(__fmul_rn(gt[r], dt0), __fmul_rn(gt[r + 2], dt1));
#pragma unroll
        for (int off = 4; off < 32; off *= 2)
          cs = __fadd_rn(cs, __shfl_xor_sync(0xffffffffu, cs, off));
        if (lane < 4) red[warp * kWRows + 8 * (ci / 2) + 2 * lane + ci % 2] = cs;
      }
      __syncthreads();
      if ((int)threadIdx.x < kWRows && i0 + (int)threadIdx.x < Q) {
        const float* rp = red + threadIdx.x;
        a.rowpart[((size_t)bh * n_t + jt) * S + (size_t)c * Q + i0 + threadIdx.x] =
            __fadd_rn(__fadd_rn(__fadd_rn(rp[0], rp[kWRows]), rp[2 * kWRows]), rp[3 * kWRows]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
    }

    // the state terms: u_j = B_j gS [P], s_j = u_j . x_j
    __syncthreads();  // every product of the row tiles is done
    load_split_sw(Sh, Sl, a.gS + ((size_t)bh * n_c + c) * (size_t)N * P, N, 0, N, P);
    tiles_ready();
    float u[P / 2];
    clear(u);
    fence_regs(u);
    wgmma_fence();
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint64_t bd = desc_b128(Bs + (kk / 4) * kWBox + 32 * (kk % 4), 16, 1024);
      mma_ss<P, 1>(u, bd, mn_desc(Sh, kk));
      mma_ss<P, 1>(u, bd, mn_desc(Sl, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(u);
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < P / 2; ++r) {
      const int p = frag_col(r);
      const __nv_bfloat16 xv = *reinterpret_cast<const __nv_bfloat16*>(
          Xs + sw128_offset(frag_row(r), p / 8, kWRows) + (p % 8) * 2);
      s[(r / 2) % 2] = fmaf(u[r], __bfloat162float(xv), s[(r / 2) % 2]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[h] = __fadd_rn(s[h], __shfl_xor_sync(0xffffffffu, s[h], 1));
      s[h] = __fadd_rn(s[h], __shfl_xor_sync(0xffffffffu, s[h], 2));
    }
#pragma unroll
    for (int r = 0; r < P / 2; r += 2) {
      const int gj = j0 + frag_row(r);
      if (gj < Q) {
        const float ed = __fmul_rn(e[gj], dt[gj]);
        *reinterpret_cast<float2*>(a.dx + (row0 + gj) * P + frag_col(r)) =
            make_float2(fmaf(ed, u[r], acc[r]), fmaf(ed, u[r + 1], acc[r + 1]));
      }
    }
    if (lane % 4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gj = j0 + frag_row(2 * h);
        if (gj >= Q) continue;
        const float sterm = __fmul_rn(__fmul_rn(e[gj], dt[gj]), s[h]);
        float* dc = a.dcum + ((size_t)bh * n_c + c) * 2 * Q;
        a.ddt[row0 + gj] = fmaf(e[gj], s[h], tcol[h]);
        dc[gj] = __fsub_rn(-__fmul_rn(dt[gj], tcol[h]), sterm);
        dc[Q + gj] = sterm;  // the states' term, summed into dcum_{Q-1} after the launch
      }
    }
  }
}

// The dB role, column tile [j0, j0 + 64), state columns [n0, n0 + NS):
// over the group's heads in order, sum over i >= j of W_ij C_i, then
// e_j dt_j (gS x_j), into one accumulator.
template <int P, int NS>
__device__ __forceinline__ void db_role(const BwdArgs& a, uint8_t* work, float* cum, float* dt,
                                        float* e, int g, int c, int n_c, int n_t, int jt, int n0) {
  const int Q = a.Q, N = a.N, S = a.S, nb = w_state_boxes(N), j0 = jt * kWRows;
  const int cols = min(NS, N - n0);
  uint8_t* Xs = work + nb * kWBox;   // x_j [64][P], the dx role's layout
  uint8_t* Cs = Xs + kWBox;          // C_i [64][NS]: the slice, MN-major
  uint8_t* Gh = Cs + nb * kWBox;     // gy_i hi, lo [64][P], K-major
  uint8_t* Gl = Gh + kWBox;
  uint8_t* Sh = Cs;                  // gS rows n0.. [NS][P], K-major: hi
  uint8_t* Sl = Sh + nb * kWBox;     // and lo
  const size_t bc0 = (size_t)(g * a.group / a.heads) * S + (size_t)c * Q;
  float acc[NS / 2];
  clear(acc);
  for (int k = 0; k < a.group; ++k) {
    const int bh = g * a.group + k;
    const size_t row0 = (size_t)bh * S + (size_t)c * Q;
    head_stripes(a, cum, dt, e, bh, row0);
    load_bf16_sw(Xs, a.x + row0 * P, P, Q, j0, 0, P);
    for (int it = jt; it < n_t; ++it) {
      const int i0 = it * kWRows;
      __syncthreads();
      load_bf16_sw(Cs, a.C + bc0 * N, N, Q, i0, n0, cols);
      load_split_sw(Gh, Gl, a.gy + row0 * P, Q, i0, kWRows, P);
      tiles_ready();
      float w[32];  // G^T, then W^T = G^T o L o dt_j, [j][i]
      clear(w);
      fence_regs(w);
      wgmma_fence();
      mma_nt(w, Xs, Gh, P);
      mma_nt(w, Xs, Gl, P);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(w);
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int gj = j0 + frag_row(r), gi = i0 + frag_col(r);
        w[r] = (gj <= gi && gi < Q)
                   ? __fmul_rn(__fmul_rn(w[r], expf(__fsub_rn(cum[gi], cum[gj]))), dt[gj])
                   : 0.f;
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t hi[4], lo[4];
        frag_split(w, kk, hi, lo);
        mma_rs<NS>(acc, hi, mn_desc(Cs, kk));
        mma_rs<NS>(acc, lo, mn_desc(Cs, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }

    // v_j = x_j gS^T for the slice, then acc += e_j dt_j v_j
    __syncthreads();
    load_split_sw(Sh, Sl, a.gS + ((size_t)bh * n_c + c) * (size_t)N * P, N, n0, NS, P);
    tiles_ready();
    // 64 state columns at a time: registers 32 h .. 32 h + 31 of a
    // [64 x 128] accumulator are columns 64 h .. 64 h + 63
#pragma unroll
    for (int h = 0; h < NS / 64; ++h) {
      float v[32];
      clear(v);
      fence_regs(v);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk) {
        const uint64_t xd = desc_b128(Xs + 32 * kk, 16, 1024);
        mma_ss<64, 0>(v, xd, desc_b128(Sh + 64 * 128 * h + 32 * kk, 16, 1024));
        mma_ss<64, 0>(v, xd, desc_b128(Sl + 64 * 128 * h + 32 * kk, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(v);
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int gj = j0 + frag_row(r);
        acc[32 * h + r] = fmaf(__fmul_rn(e[gj], dt[gj]), v[r], acc[32 * h + r]);
      }
    }
  }
  float* out = a.dB + ((size_t)g * S + (size_t)c * Q) * N;
#pragma unroll
  for (int r = 0; r < NS / 2; r += 2) {
    const int gj = j0 + frag_row(r), n = n0 + frag_col(r);
    if (gj < Q && n < N)
      *reinterpret_cast<float2*>(out + (size_t)gj * N + n) = make_float2(acc[r], acc[r + 1]);
  }
}

// The dC role, row tile [i0, i0 + 64), state columns [n0, n0 + NS): over
// the group's heads in order, sum over j <= i of W_ij B_j.
template <int P, int NS>
__device__ __forceinline__ void dc_role(const BwdArgs& a, uint8_t* work, float* cum, float* dt,
                                        float* e, int g, int c, int it, int n0) {
  const int Q = a.Q, N = a.N, S = a.S, i0 = it * kWRows;
  const int cols = min(NS, N - n0);
  uint8_t* Gh = work;                // gy_i hi, lo [64][P], K-major
  uint8_t* Gl = Gh + kWBox;
  uint8_t* Xs = Gl + kWBox;          // x_j [64][P], K-major
  uint8_t* Bs = Xs + kWBox;          // B_j [64][NS]: the slice, MN-major
  const size_t bc0 = (size_t)(g * a.group / a.heads) * S + (size_t)c * Q;
  float acc[NS / 2];
  clear(acc);
  for (int k = 0; k < a.group; ++k) {
    const int bh = g * a.group + k;
    const size_t row0 = (size_t)bh * S + (size_t)c * Q;
    head_stripes(a, cum, dt, e, bh, row0);
    load_split_sw(Gh, Gl, a.gy + row0 * P, Q, i0, kWRows, P);
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kWRows;
      if (jt > 0) __syncthreads();  // the last tile's products are done
      load_bf16_sw(Xs, a.x + row0 * P, P, Q, j0, 0, P);
      load_bf16_sw(Bs, a.B + bc0 * N, N, Q, j0, n0, cols);
      tiles_ready();
      float w[32];  // G, then W = G o L o dt_j, [i][j]
      clear(w);
      fence_regs(w);
      wgmma_fence();
      mma_nt(w, Gh, Xs, P);
      mma_nt(w, Gl, Xs, P);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(w);
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int gi = i0 + frag_row(r), gj = j0 + frag_col(r);
        w[r] = (gj <= gi && gi < Q)
                   ? __fmul_rn(__fmul_rn(w[r], expf(__fsub_rn(cum[gi], cum[gj]))), dt[gj])
                   : 0.f;
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t hi[4], lo[4];
        frag_split(w, kk, hi, lo);
        mma_rs<NS>(acc, hi, mn_desc(Bs, kk));
        mma_rs<NS>(acc, lo, mn_desc(Bs, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
  }
  float* out = a.dC + ((size_t)g * S + (size_t)c * Q) * N;
#pragma unroll
  for (int r = 0; r < NS / 2; r += 2) {
    const int gi = i0 + frag_row(r), n = n0 + frag_col(r);
    if (gi < Q && n < N)
      *reinterpret_cast<float2*>(out + (size_t)gi * N + n) = make_float2(acc[r], acc[r + 1]);
  }
}

// Grid: x = group of heads * n_c + chunk; y = rank k * (1 + 2 n_s) + role:
// the dx block of column tile k, the dB blocks of column tile k (one a
// state slice), the dC blocks of row tile n_t - 1 - k; rank 0 carries the
// most tile pairs.
template <int P, int NS>
__global__ void __launch_bounds__(kWThreads, 2) ssd_chunk_bwd_wgmma_kernel(const BwdArgs a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* cum = reinterpret_cast<float*>(base);  // [kMaxChunk]
  float* dt = cum + kMaxChunk;                  // [kMaxChunk], 0 past Q
  float* e = dt + kMaxChunk;                    // [kMaxChunk]: exp(cum_{Q-1} - cum)
  float* red = e + kMaxChunk;                   // [4][64]: the dx role's column sums
  uint8_t* work = base + kWStripeBytes;         // 1024-aligned
  const int n_c = a.S / a.Q, n_t = (a.Q + kWRows - 1) / kWRows, n_s = (a.N + NS - 1) / NS;
  const int g = blockIdx.x / n_c, c = blockIdx.x % n_c;
  const int k = blockIdx.y / (1 + 2 * n_s), role = blockIdx.y % (1 + 2 * n_s);
  if (role == 0) {
    dx_role<P>(a, work, cum, dt, e, red, g, c, n_c, n_t, k);
  } else if (role <= n_s) {
    db_role<P, NS>(a, work, cum, dt, e, g, c, n_c, n_t, k, (role - 1) * NS);
  } else {
    dc_role<P, NS>(a, work, cum, dt, e, g, c, n_t - 1 - k, (role - 1 - n_s) * NS);
  }
}

template <int P, int NS>
cudaError_t run_bwd_wgmma(const BwdArgs& a, int BH, cudaStream_t stream) {
  // 16-byte loads: aligned bases; rows of N and P values are 16-byte multiples
  if ((reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.B) |
       reinterpret_cast<uintptr_t>(a.C) | reinterpret_cast<uintptr_t>(a.gy) |
       reinterpret_cast<uintptr_t>(a.gS)) % 16)
    return cudaErrorInvalidValue;
  auto kernel = ssd_chunk_bwd_wgmma_kernel<P, NS>;
  const int smem = wgmma_bwd_smem_bytes(a.N);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_t = (a.Q + kWRows - 1) / kWRows, n_s = (a.N + NS - 1) / NS;
  dim3 grid((unsigned)(BH / a.group) * (unsigned)(a.S / a.Q), n_t * (1 + 2 * n_s));
  kernel<<<grid, kWThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int P>
cudaError_t dispatch_bwd_wgmma(const BwdArgs& a, int BH, cudaStream_t s) {
  return a.N <= 64 ? run_bwd_wgmma<P, 64>(a, BH, s) : run_bwd_wgmma<P, 128>(a, BH, s);
}

}  // namespace repro

extern "C" {

// x_bf16: x, B and C are bf16 (1) or fp32 (0); B and C are [BH/heads, S,
// N].  dt, A, gy [BH,S,P] and gS [BH,S/Q,N,P] are fp32.  Outputs, fp32:
// dx [BH,S,P]; ddt [BH,S] (the direct term); dcum [BH,S/Q,2,Q] (the
// column terms, then the states' terms); rowpart [BH,ceil(Q/64),S] (each
// column tile's row sums of R, 0 where the tile has none: the caller
// zeroes it); dB, dC [BH/group,S,N], each summed over `group` consecutive
// heads (group divides heads).  kind 0 (simt): group 1, head dims P of
// 16, 32 and 64; kind 2 (wgmma): bf16 only, P of 32 and 64, N a multiple
// of 16 up to 256, x, B, C, gy and gS 16-byte aligned.
int ssd_chunk_bwd(const void* x, const void* dt, const void* A, const void* B, const void* C,
                  const void* gy, const void* gS, void* dx, void* ddt, void* dcum, void* rowpart,
                  void* dB, void* dC, int x_bf16, int BH, int S, int Q, int N, int P, int heads,
                  int kind, int group, void* stream) {
  if (Q < 1 || Q > repro::kMaxChunk || S % Q != 0 || N < 1 || heads < 1 || BH % heads != 0 ||
      group < 1 || heads % group != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 2) {
    if (!x_bf16 || N % 16 != 0 || N > repro::kWMaxState) return cudaErrorInvalidValue;
    const repro::BwdArgs a{
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(B),
        static_cast<const __nv_bfloat16*>(C), static_cast<const float*>(dt),
        static_cast<const float*>(A),         static_cast<const float*>(gy),
        static_cast<const float*>(gS),        static_cast<float*>(dx),
        static_cast<float*>(ddt),             static_cast<float*>(dcum),
        static_cast<float*>(rowpart),         static_cast<float*>(dB),
        static_cast<float*>(dC),              S, Q, N, heads, group};
    if (P == 64) return repro::dispatch_bwd_wgmma<64>(a, BH, s);
    if (P == 32) return repro::dispatch_bwd_wgmma<32>(a, BH, s);
    return cudaErrorInvalidValue;
  }
  if (kind != 0 || group != 1) return cudaErrorInvalidValue;
  if (x_bf16)
    return repro::dispatch_bwd<__nv_bfloat16>(P, x, dt, A, B, C, gy, gS, dx, ddt, dcum, rowpart,
                                              dB, dC, BH, S, Q, N, heads, s);
  return repro::dispatch_bwd<float>(P, x, dt, A, B, C, gy, gS, dx, ddt, dcum, rowpart, dB, dC,
                                    BH, S, Q, N, heads, s);
}

// Shared memory of one launch of `kind` (0 simt, 2 wgmma) with state size
// N and head dim P.
int ssd_chunk_bwd_smem_bytes(int N, int P, int kind) {
  return kind == 2 ? repro::wgmma_bwd_smem_bytes(N) : repro::bwd_smem_bytes(N, P);
}

}  // extern "C"
