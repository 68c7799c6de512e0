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
// Split over thread blocks as the forward's simt kind is: a chunk's
// [Q x Q] tiles do not fit one block, so one launch runs three roles per
// (b*h, chunk), over 64-row tiles, each visiting only the tiles i >= j:
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
// No atomics: every sum runs in one fixed order inside its block, so a
// repeat is bitwise equal.  What crosses blocks goes through device
// memory and a small fixed-order torch pass after the launch
// (kernels/ssd_scan.py::_launch_bwd): the sum of the column tiles' dcum
// partials, the states' dcum_{Q-1} term, the reverse cumsum, the
// -A rc term of ddt, the dA reduction over the chunks, and the sum of dB
// and dC over the heads that share a row of B and C.
//
// Arithmetic: plain fp32 FMA from shared memory (simt); x, B and C are
// read as bf16 or fp32, dt, A, gy and gS are fp32, every output fp32.
// cum is recomputed by one thread in order 0..Q-1 with the forward simt
// kind's rounding.  Q is a runtime value from 1 to 256 (ragged tiles
// masked, as in the forward); P is 16, 32 or 64 (compiled), N any value
// up to 256 that fits the column block's shared memory.
//
// Bound on the H100: at mamba2-370m's training shape (B 8, 32 heads,
// S 1024, P 64, N 128, Q 256) one call reads x, B, C (bf16), gy and gS
// and writes dx, ddt, the per-head dB and dC partials and the dcum
// partials (fp32), ~0.23 GB, 0.07 ms at 3.35 TB/s, against ~32 GFLOP
// (the causal half of the CB, G, dx, dB and dC tile products, the
// states) at 0.03 ms at the bf16 tensor-core peak: bound by bytes.  This
// first version runs fp32 FMA on the CUDA cores and is far from both;
// tensor cores (as the forward's wgmma kind) are later work.
//
// Plain C interface for ctypes: ssd_chunk_bwd returns the CUDA error of
// the launch (0 on success); ssd_chunk_bwd_smem_bytes gives the shared
// memory of a launch, which kernels/ssd_scan.py::bwd_smem_bytes mirrors.
#include <cstdint>

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

}  // namespace repro

extern "C" {

// x_bf16: x, B and C are bf16 (1) or fp32 (0); B and C are [BH/heads, S,
// N].  dt, A, gy [BH,S,P] and gS [BH,S/Q,N,P] are fp32.  Outputs, fp32:
// dx [BH,S,P]; ddt [BH,S] (the direct term); dcum [BH,S/Q,2,Q] (the
// column terms, then the states' terms); rowpart [BH,ceil(Q/64),S] (each
// column tile's row sums of R, 0 where the tile has none: the caller
// zeroes it); dB, dC [BH,S,N] per head.
int ssd_chunk_bwd(const void* x, const void* dt, const void* A, const void* B, const void* C,
                  const void* gy, const void* gS, void* dx, void* ddt, void* dcum, void* rowpart,
                  void* dB, void* dC, int x_bf16, int BH, int S, int Q, int N, int P, int heads,
                  void* stream) {
  if (Q < 1 || Q > repro::kMaxChunk || S % Q != 0 || N < 1 || heads < 1 || BH % heads != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return repro::dispatch_bwd<__nv_bfloat16>(P, x, dt, A, B, C, gy, gS, dx, ddt, dcum, rowpart,
                                              dB, dC, BH, S, Q, N, heads, s);
  return repro::dispatch_bwd<float>(P, x, dt, A, B, C, gy, gS, dx, ddt, dcum, rowpart, dB, dC,
                                    BH, S, Q, N, heads, s);
}

// Shared memory of one launch with state size N and head dim P.
int ssd_chunk_bwd_smem_bytes(int N, int P) { return repro::bwd_smem_bytes(N, P); }

}  // extern "C"
