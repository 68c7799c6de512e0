// block_fused_ffn for Hopper (sm_90a): the LBM (layer-block mapping)
// SwiGLU FFN,  y[S,d] = ((silu(x@wg) * (x@wu)).astype(x.dtype)) @ wd,
// with fp32 accumulation and y in x's type (fp32 or bf16).
//
// Replaces the Pallas TPU kernel src/repro/kernels/block_fused_ffn.py::
// block_fused_ffn (body _ffn_kernel).  The promise kept is the LBM one:
// the [bs, bf] hidden tile h never reaches device memory; it is computed
// in registers, rounded to x's type (as the TPU kernel rounds before its
// down product) and kept in shared memory for the down product.
//
// Design.  The TPU kernel keeps a resident [bs, d_model] fp32 accumulator
// in VMEM while it walks the d_ff blocks in order.  At full width
// (d_model 4096, bs 128) that is 2 MiB: no thread block holds it.  This
// kernel therefore splits over d_ff instead: block (i, j) owns rows
// [i*BS, i*BS+BS) and d_ff columns [j*BF, j*BF+BF); it computes g and u
// for its columns (K = d_model), forms h on chip, multiplies h by its
// BF rows of wd across all of d_model in BF-wide column chunks, and
// writes an fp32 partial output P[j, s, :].  A second kernel sums the
// n_f = ceil(d_ff/BF) partials of each output in fixed order j = 0..n_f-1
// and casts.  No atomics: the sum order never changes from run to run,
// so the port's serial and pipelined serving loops stay bit-identical.
// Cost of the design: no extra weight reads (every weight element is
// read once per S block), plus n_f * S * d_model * 4 bytes of partials
// written and read once; at decode (S = 2, d_ff 11008, BF = 64) that is
// 2 x 5.6 MB against 270 MB of weights.
//
// Bound on the H100: at decode the FFN does 2 FLOP per weight element
// read, so it is bound by the weight bytes (3 * d_model * d_ff elements).
// The small BF keeps ceil(11008 / 64) = 172 blocks in flight so that the
// weight stream covers every SM; the rows of S are masked in the kernel
// (BS = 8 at decode) instead of padding S to 128 rows through device
// memory.  Plain FMA, no tensor cores; later PRs pipeline it.
//
// Plain C interface for ctypes: each entry point returns the CUDA error
// of its launches (0 on success); `tile` indexes the menu below, which
// kernels/block_fused_ffn.py::TILES mirrors and checks through
// block_fused_ffn_tile().
#include "tile_common.cuh"

namespace repro {

template <int BS, int BF, int BK, int TM, int TN>
struct FfnTile {
  static constexpr int bs = BS, bf = BF, bk = BK, tm = TM, tn = TN;
  static constexpr int threads = (BS / TM) * (BF / TN);
  // shared-memory layout, in floats
  static constexpr int x_ld = BS + 1, h_ld = BS + 1;
  static constexpr int x_off = 0;                      // x tile   [BK][BS+1], k-major
  static constexpr int g_off = x_off + BK * x_ld;      // wg tile  [BK][BF]
  static constexpr int u_off = g_off + BK * BF;        // wu tile  [BK][BF]
  static constexpr int h_off = u_off + BK * BF;        // h        [BF][BS+1], f-major
  static constexpr int w_off = h_off + BF * h_ld;      // wd chunk [BF][BF]
  static constexpr int floats = w_off + BF * BF;
  static constexpr int smem = (int)sizeof(float) * floats;
};

template <typename T, typename TL>
__global__ void __launch_bounds__(TL::threads)
    ffn_partial_kernel(const T* __restrict__ X, const T* __restrict__ Wg,
                       const T* __restrict__ Wu, const T* __restrict__ Wd,
                       float* __restrict__ P, int S, int D, int F) {
  constexpr int BS = TL::bs, BF = TL::bf, BK = TL::bk, TM = TL::tm, TN = TL::tn;
  constexpr int NT = TL::threads;
  extern __shared__ float smem[];
  float* Xs = smem + TL::x_off;
  float* Gs = smem + TL::g_off;
  float* Us = smem + TL::u_off;
  float* Hs = smem + TL::h_off;
  float* Ws = smem + TL::w_off;
  const int tx = threadIdx.x % (BF / TN);
  const int ty = threadIdx.x / (BF / TN);
  const int f0 = blockIdx.x * BF;
  const int s0 = blockIdx.y * BS;

  // g, u = x @ wg[:, f0:f0+BF], x @ wu[:, f0:f0+BF]  (K = d_model)
  float g[TM][TN], u[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) g[i][j] = u[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += BK) {
    load_tile<T, BS, BK, NT, true>(Xs, TL::x_ld, X, S, D, D, s0, k0);
    load_tile<T, BK, BF, NT, false>(Gs, BF, Wg, D, F, F, k0, f0);
    load_tile<T, BK, BF, NT, false>(Us, BF, Wu, D, F, F, k0, f0);
    __syncthreads();
    fma_tile<BS, BF, TM, TN, BK>(g, Xs, TL::x_ld, Gs, BF, ty, tx);
    fma_tile<BS, BF, TM, TN, BK>(u, Xs, TL::x_ld, Us, BF, ty, tx);
    __syncthreads();
  }

  // h = (silu(g) * u) rounded to x's type; shared memory only.  Columns
  // past d_ff had zero weights, so their h is exactly zero.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float gv = g[i][j];
      const float h = (gv / (1.f + expf(-gv))) * u[i][j];
      Hs[(tx + j * (BF / TN)) * TL::h_ld + ty + i * (BS / TM)] = to_f32(from_f32<T>(h));
    }
  }
  __syncthreads();

  // P[blockIdx.x, s, :] = h @ wd[f0:f0+BF, :], BF output columns at a time
  for (int d0 = 0; d0 < D; d0 += BF) {
    load_tile<T, BF, BF, NT, false>(Ws, BF, Wd, F, D, D, f0, d0);
    __syncthreads();
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    fma_tile<BS, BF, TM, TN, BF>(acc, Hs, TL::h_ld, Ws, BF, ty, tx);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int s = s0 + ty + i * (BS / TM);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int d = d0 + tx + j * (BF / TN);
        if (s < S && d < D) P[((size_t)blockIdx.x * S + s) * D + d] = acc[i][j];
      }
    }
    __syncthreads();
  }
}

// y = cast(sum_j P[j]) with j in fixed order 0..n_f-1.
template <typename T>
__global__ void ffn_reduce_kernel(const float* __restrict__ P, T* __restrict__ Y, int n_f,
                                  long long SD) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= SD) return;
  float s = 0.f;
  for (int j = 0; j < n_f; ++j) s += P[(size_t)j * SD + i];
  Y[i] = from_f32<T>(s);
}

template <typename T, typename TL>
cudaError_t run(const T* x, const T* wg, const T* wu, const T* wd, float* partial, T* y, int S,
                int D, int F, cudaStream_t s) {
  auto kernel = ffn_partial_kernel<T, TL>;
  cudaError_t e = set_smem(kernel, TL::smem);
  if (e != cudaSuccess) return e;
  const int n_f = (F + TL::bf - 1) / TL::bf;
  dim3 grid(n_f, (S + TL::bs - 1) / TL::bs);
  kernel<<<grid, TL::threads, TL::smem, s>>>(x, wg, wu, wd, partial, S, D, F);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long SD = (long long)S * D;
  const int rt = 256;
  ffn_reduce_kernel<T><<<(unsigned)((SD + rt - 1) / rt), rt, 0, s>>>(partial, y, n_f, SD);
  return cudaGetLastError();
}

// The compiled tile menu, by index (kernels/block_fused_ffn.py::TILES).
using F0 = FfnTile<8, 64, 64, 1, 2>;    // decode: S <= 8
using F1 = FfnTile<16, 64, 32, 2, 2>;
using F2 = FfnTile<32, 64, 32, 2, 4>;
using F3 = FfnTile<64, 64, 32, 4, 4>;

template <typename T>
int dispatch(int tile, const void* x, const void* wg, const void* wu, const void* wd,
             void* partial, void* y, int S, int D, int F, void* stream) {
  const T* X = static_cast<const T*>(x);
  const T* G = static_cast<const T*>(wg);
  const T* U = static_cast<const T*>(wu);
  const T* W = static_cast<const T*>(wd);
  float* P = static_cast<float*>(partial);
  T* Y = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: return run<T, F0>(X, G, U, W, P, Y, S, D, F, s);
    case 1: return run<T, F1>(X, G, U, W, P, Y, S, D, F, s);
    case 2: return run<T, F2>(X, G, U, W, P, Y, S, D, F, s);
    case 3: return run<T, F3>(X, G, U, W, P, Y, S, D, F, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TL>
void describe(int* out) {
  out[0] = TL::bs; out[1] = TL::bf; out[2] = TL::bk;
  out[3] = TL::tm; out[4] = TL::tn; out[5] = TL::smem;
}

}  // namespace repro

extern "C" {

int block_fused_ffn_f32(const void* x, const void* wg, const void* wu, const void* wd,
                        void* partial, void* y, int S, int D, int F, int tile, void* stream) {
  return repro::dispatch<float>(tile, x, wg, wu, wd, partial, y, S, D, F, stream);
}

int block_fused_ffn_bf16(const void* x, const void* wg, const void* wu, const void* wd,
                         void* partial, void* y, int S, int D, int F, int tile, void* stream) {
  return repro::dispatch<__nv_bfloat16>(tile, x, wg, wu, wd, partial, y, S, D, F, stream);
}

// Writes (bs, bf, bk, tm, tn, shared-memory bytes) of menu entry `tile`;
// returns the number of entries.
int block_fused_ffn_tile(int tile, int* out) {
  switch (tile) {
    case 0: repro::describe<repro::F0>(out); break;
    case 1: repro::describe<repro::F1>(out); break;
    case 2: repro::describe<repro::F2>(out); break;
    case 3: repro::describe<repro::F3>(out); break;
    default: break;
  }
  return 4;
}

}  // extern "C"
