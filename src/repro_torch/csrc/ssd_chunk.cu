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
// peak, so it is bound by bytes.  This first version is plain fp32 FMA
// from shared memory, no tensor cores, and far off that bound; making it
// fast (wgmma on bf16 tiles, a parallel scan, the states fused into the
// y blocks) is later work.
//
// Plain C interface for ctypes: ssd_chunk_fwd returns the CUDA error of
// the launch (0 on success); ssd_chunk_smem_bytes gives the shared
// memory of a launch, which kernels/ssd_scan.py::smem_bytes mirrors.
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

}  // namespace repro

extern "C" {

// x_bf16: x, B and C are bf16 (1) or fp32 (0).  B and C are [BH/heads,
// S, N]; head dims P of 16, 32 and 64 are compiled.
int ssd_chunk_fwd(const void* x, const void* dt, const void* A, const void* B, const void* C,
                  void* y, void* states, int x_bf16, int BH, int S, int Q, int N, int P,
                  int heads, void* stream) {
  if (Q < 1 || Q > repro::kMaxChunk || S % Q != 0 || N < 1 || heads < 1 || BH % heads != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return repro::dispatch<__nv_bfloat16>(P, x, dt, A, B, C, y, states, BH, S, Q, N, heads, s);
  return repro::dispatch<float>(P, x, dt, A, B, C, y, states, BH, S, Q, N, heads, s);
}

// Shared memory of one launch with state size N and head dim P.
int ssd_chunk_smem_bytes(int N, int P) { return repro::smem_bytes(N, P); }

}  // extern "C"
