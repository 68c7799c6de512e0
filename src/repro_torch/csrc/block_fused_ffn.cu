// block_fused_ffn for Hopper (sm_90a): the LBM (layer-block mapping)
// SwiGLU FFN,  y[S,d] = ((silu(x@wg) * (x@wu)).astype(x.dtype)) @ wd,
// with fp32 accumulation and y in x's type (fp32 or bf16).
//
// Replaces the Pallas TPU kernel src/repro/kernels/block_fused_ffn.py::
// block_fused_ffn (body _ffn_kernel).  The promise kept is the LBM one:
// the [bs, bf] hidden tile h never reaches device memory; it is computed
// on chip and rounded to x's type (as the TPU kernel rounds before its
// down product).
//
// Split.  The TPU kernel keeps a resident [bs, d_model] fp32 accumulator
// in VMEM while it walks the d_ff blocks in order.  At full width
// (d_model 4096, bs 128) that is 2 MiB: no thread block holds it.  The
// kernels here split over d_ff instead: a block owns rows [s0, s0 + BS)
// and d_ff columns [f0, f0 + BF), computes g and u for its columns
// (K = d_model), forms h on chip, multiplies h by its BF rows of wd
// across all of d_model, and writes fp32 partial outputs; a second pass
// sums the partials of each output in a fixed order and casts.  No
// atomics: the sum order never changes from run to run, so the port's
// serial and pipelined serving loops stay bit-identical.  Every weight
// element is read once per row block.
//
// Three tile kinds, one menu (kernels/ops.py::legalize_ffn_tile picks the
// kind by dtype, rows and alignment):
//
//  * simt (fp32, and bf16 rows TMA or 16-byte loads cannot take; the
//    first design): plain fp32 FMA from shared memory, h kept in shared
//    memory, one [S, d] partial slab per BF-wide d_ff block
//    (n_f = ceil(d_ff / BF) slabs).  At prefill the slabs are the
//    problem: at 2048 x 4096 and 64-wide tiles, 172 slabs are 5.77 GB
//    written and read again, more than six times the whole FFN's 0.56 ms
//    bound.
//  * gemv (bf16 decode rows, S <= 8; d_model and d_ff multiples of 8).
//    The FFN does 2 FLOP per weight element there, so it is bound by the
//    weight bytes (yi-9b, 2 x 4096, d_ff 11008: 270 MB, 0.081 ms on an
//    H100).  Two things keep a one-block-per-tile design from streaming
//    them: a 64-wide d_ff tile gives whisper-tiny's d_ff 1536 only 24
//    blocks for 132 SMs, and each block walks all of d_model alone.  So
//    each 64-wide d_ff tile gets a thread-block cluster of C blocks
//    (gemv_cluster in kernels/block_fused_ffn.py: two blocks an SM, at
//    least 64 d_model rows a block, C in 1, 2, 4, 8):
//    1. Block r of the cluster takes d_model rows [r d / C, (r + 1) d / C)
//       of Wg and Wu: each thread streams 16-byte vectors (8 d_ff
//       columns of a row) into registers, four rows of each matrix in
//       flight, against x staged in shared memory as fp32, and sums its
//       rows; the warp's four row lanes add by shuffles, the 8 warps in
//       order through shared memory: g and u partials [S, 64] (4 KB at
//       S 8).
//    2. Behind a cluster barrier every block adds the C partials of g
//       and of u in rank order through distributed shared memory (all C
//       blocks form the same sums), and forms h = bf16(silu(g) * u) in
//       shared memory, rounded as the reference rounds: h never reaches
//       device memory.
//    3. Block r multiplies h by its d_model / C columns of the tile's 64
//       rows of Wd, again in 16-byte vectors (rows split over up to 32
//       thread groups, added in order), and writes them into the tile's
//       fp32 [S, d] slab; the cluster writes the whole slab once.  The
//       fixed-order ffn_reduce_kernel adds the n_f slabs (yi-9b: 5.6 MB
//       of partials against 270 MB of weights).
//    Every weight element is read by one block once; every sum has one
//    order (a function of the shapes and the SM count alone); no atomics.
//  * wgmma (bf16, more than 8 rows; the prefill, 2048 x 4096, d_ff 11008:
//    554 GFLOP, bound by operations at 0.56 ms).  Block = (BS-row block,
//    128-wide d_ff tile), BS / 64 consumer warpgroups of 64 rows.
//    1. Gate and up in one pass: a 3-stage TMA ring stages an x chunk
//       [BS x 64] (K-major) and the Wg and Wu chunks [64 x 128]
//       (MN-major, as cache_matmul's B); each warpgroup accumulates g and
//       u, [64 x 128] fp32 each, with wgmma m64n128k16.
//    2. h = silu(g) * u, rounded to bf16 as the reference rounds, is
//       formed in registers directly as wgmma's register A fragments (the
//       accumulator and A fragment layouts line up for 16-bit types, as
//       for p in flash_attention.cu): h touches neither device nor shared
//       memory.
//    3. The down product walks d_model in 128-wide chunks of Wd through
//       the same ring; each chunk's [BS x 128] fp32 result is one partial
//       of this block's d_ff tile.  The next chunk's products run while
//       the cluster sums this one (step 4).
//    4. A thread-block cluster of 8 blocks along d_ff (one row block)
//       cuts the partial slabs: after each chunk every block stages its
//       result in shared memory; behind a cluster barrier, block r sums
//       its BS / 8 rows of the chunk over the 8 peers in the fixed order
//       0..7 through distributed shared memory and stores one slab.  At
//       the prefill shape the slabs fall from 172 to ceil(86 / 8) = 11:
//       0.37 GB each way, not 5.77.  Blocks past d_ff in the last cluster
//       load zero weights through TMA's out-of-bounds fill and add an
//       exact zero.  A second cluster barrier, whose wait comes just
//       before the next chunk's staging, keeps a block from overwriting
//       its exchange chunk while a peer still reads it (a relaxed
//       arrival: the reads are consumed before it).  This exchange is
//       what bounds the kernel now: on an H100 at the prefill shape the
//       remote reads (2.9 GB a launch) take the largest share, then the
//       barriers (pushing the rows to their owners with remote stores
//       instead was slower still).
//    There is no producer warp: thread 0 issues the TMA loads of stage
//    t + 3 once both warpgroups have released stage t, so every thread of
//    the cluster takes part in the cluster barriers (a producer blocked
//    on a ring slot while its peers wait at a cluster barrier would
//    deadlock).  The blocks of a cluster-wide d_ff group are launched for
//    every row block before the next group (grid x: rank, y: row block,
//    z: d_ff group), so each weight tile is read by all row blocks of a
//    wave at about the same time and crosses device memory about once,
//    while x (16 MB) stays in L2.  TMA needs 16-byte row strides: d_model
//    and d_ff multiples of 8; the legalization sends other shapes to a
//    simt tile.
//
// Plain C interface for ctypes: each entry point returns the CUDA error
// of its launches (0 on success); `tile` indexes the menu below, which
// kernels/block_fused_ffn.py::TILES mirrors and checks through
// block_fused_ffn_tile().
#include "hopper_async.cuh"
#include "tile_common.cuh"

namespace repro {

template <int BS, int BF, int BK, int TM, int TN>
struct FfnTile {
  static constexpr int kind = 0;    // simt
  static constexpr int dtypes = 3;  // fp32 | bf16
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

// --------------------------------------------------------------- wgmma --
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Split cluster barrier: every thread of every block of the cluster
// arrives (release, or relaxed where nothing needs ordering) and later
// waits (acquire), in alternation.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// Four floats at shared-memory address `addr` of cluster block `rank`.
__device__ __forceinline__ float4 ld_peer_f4(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

constexpr int FFN_CLUSTER = 8;  // blocks along d_ff that share one row block

template <int BS>
struct FfnWgmma {
  static constexpr int kind = 2, dtypes = 2;  // wgmma; bf16
  static constexpr int bs = BS, bf = 128, bk = 64, tm = 64, tn = 128;
  static constexpr int stages = 3;
  static constexpr int consumers = BS / 64;      // warpgroups of 64 rows
  static constexpr int threads = 128 * consumers;
  static constexpr int x_bytes = BS * 64 * 2;    // x chunk [BS][64], K-major
  static constexpr int w_bytes = 64 * 128 * 2;   // Wg / Wu chunk: two [64 k][64 f] boxes
  static constexpr int d_bytes = 128 * 128 * 2;  // Wd chunk: two [128 f][64 n] boxes
  static constexpr int slot = x_bytes + 2 * w_bytes > d_bytes ? x_bytes + 2 * w_bytes : d_bytes;
  static constexpr int ex_ld = 136;              // floats a row of the exchange chunk (padded)
  // 1024 to align to the swizzle atom, the ring, the fp32 exchange chunk
  // [BS][128] and a full and an empty barrier per stage
  static constexpr int smem = 1024 + stages * slot + BS * ex_ld * 4 + 2 * stages * 8;
};

// Load stage t of the block's sequence: t < kt, the gate / up chunk t
// (d_model rows 64 t ..); else the Wd chunk c = t - kt (d_model columns
// 128 c ..).
template <typename TL>
__device__ __forceinline__ void ffn_issue(int t, int kt, uint8_t* ring, uint64_t* full,
                                          const CUtensorMap* tx, const CUtensorMap* tg,
                                          const CUtensorMap* tu, const CUtensorMap* td,
                                          int s0, int f0) {
  const int s = t % TL::stages;
  uint8_t* dst = ring + s * TL::slot;
  if (t < kt) {
    mbar_expect_tx(&full[s], TL::x_bytes + 2 * TL::w_bytes);
    tma_load_2d(dst, tx, &full[s], 64 * t, s0);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      tma_load_2d(dst + TL::x_bytes + j * 8192, tg, &full[s], f0 + 64 * j, 64 * t);
      tma_load_2d(dst + TL::x_bytes + TL::w_bytes + j * 8192, tu, &full[s], f0 + 64 * j, 64 * t);
    }
  } else {
    const int c = t - kt;
    mbar_expect_tx(&full[s], TL::d_bytes);
#pragma unroll
    for (int j = 0; j < 2; ++j) tma_load_2d(dst + j * 16384, td, &full[s], 128 * c + 64 * j, f0);
  }
}

// Grid (8, row blocks, d_ff groups); the cluster is the 8 blocks of x.
// P [groups, S, D] fp32: one slab per cluster.
template <typename TL>
__global__ void __cluster_dims__(FFN_CLUSTER, 1, 1) __launch_bounds__(TL::threads, 1)
    ffn_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_x,
                     const __grid_constant__ CUtensorMap tmap_g,
                     const __grid_constant__ CUtensorMap tmap_u,
                     const __grid_constant__ CUtensorMap tmap_d, float* __restrict__ P, int S,
                     int D) {
  constexpr int BS = TL::bs, ST = TL::stages, LD = TL::ex_ld;
  constexpr int ROWS = BS / FFN_CLUSTER;  // rows of each chunk this block sums
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* ex = reinterpret_cast<float*>(ring + ST * TL::slot);
  uint64_t* full = reinterpret_cast<uint64_t*>(ex + BS * LD);
  uint64_t* empty = full + ST;
  const uint32_t rank = cluster_rank();
  const int f0 = (blockIdx.z * FFN_CLUSTER + rank) * TL::bf;
  const int s0 = blockIdx.y * BS;
  const int kt = (D + 63) / 64, kc = (D + 127) / 128, total = kt + kc;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], TL::consumers);
    }
    mbar_fence_init();
    for (int t = 0; t < ST && t < total; ++t)
      ffn_issue<TL>(t, kt, ring, full, &tmap_x, &tmap_g, &tmap_u, &tmap_d, s0, f0);
  }
  __syncthreads();

  // Stage t is done with: both warpgroups arrive; thread 0 then refills
  // its slot with stage t + ST.
  auto release = [&](int t) {
    if (tid == 0) mbar_arrive(&empty[t % ST]);
    if (threadIdx.x == 0 && t + ST < total) {
      mbar_wait(&empty[t % ST], (t / ST) & 1);
      ffn_issue<TL>(t + ST, kt, ring, full, &tmap_x, &tmap_g, &tmap_u, &tmap_d, s0, f0);
    }
    __syncwarp();  // warp 0 converges again before the next wgmma
  };

  // 1. g, u = x @ Wg[:, f0:f0+128], x @ Wu[:, f0:f0+128]  (K = d_model)
  float g[64], u[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) g[i] = u[i] = 0.f;
  for (int t = 0; t < kt; ++t) {
    const int s = t % ST;
    mbar_wait(&full[s], (t / ST) & 1);
    const uint8_t* xa = ring + s * TL::slot + wg * 64 * 128;
    const uint8_t* gb = ring + s * TL::slot + TL::x_bytes;
    const uint8_t* ub = gb + TL::w_bytes;
    fence_regs(g);
    fence_regs(u);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = desc_b128(xa + 32 * kk, 16, 1024);
      wgmma_m64n128k16_ss<1>(g, da, desc_b128(gb + 2048 * kk, 8192, 1024));
      wgmma_m64n128k16_ss<1>(u, da, desc_b128(ub + 2048 * kk, 8192, 1024));
    }
    wgmma_commit();
    // the previous chunk's products are done: release its stage
    wgmma_wait<1>();
    fence_regs(g);
    fence_regs(u);
    if (t > 0) release(t - 1);
  }
  wgmma_wait<0>();
  fence_regs(g);
  fence_regs(u);
  release(kt - 1);

  // 2. h = bf16(silu(g) * u) as wgmma A fragments: hf[q] holds the
  // accumulator pair 2q, 2q + 1 (columns past d_ff had zero weights: h = 0)
  uint32_t hf[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const float a = g[2 * q], b = g[2 * q + 1];
    hf[q] = pack_bf16(a / (1.f + expf(-a)) * u[2 * q], b / (1.f + expf(-b)) * u[2 * q + 1]);
  }

  // 3. and 4. for each 128-wide chunk of d_model: this block's partial,
  // then the cluster's sum of it over the 8 d_ff tiles.  Chunk c + 1's
  // products are issued as soon as chunk c's result is staged, so they
  // run on the tensor cores while the cluster sums chunk c.
  float acc[64];
  auto issue_down = [&](int c) {
    const int t = kt + c, s = t % ST;
    mbar_wait(&full[s], (t / ST) & 1);
    const uint8_t* db = ring + s * TL::slot;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t a[4] = {hf[4 * kk], hf[4 * kk + 1], hf[4 * kk + 2], hf[4 * kk + 3]};
      wgmma_m64n128k16_rs<1>(acc, a, desc_b128(db + 2048 * kk, 16384, 1024));
    }
    wgmma_commit();
    fence_regs(acc);
  };
  issue_down(0);
  for (int c = 0; c < kc; ++c) {
    wgmma_wait<0>();
    fence_regs(acc);
    release(kt + c);
    if (c > 0) cluster_wait();  // the peers have read the last chunk
    const int r0 = wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(ex + (r0 + 8 * h) * LD + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
    if (c + 1 < kc) issue_down(c + 1);
    cluster_arrive();
    cluster_wait();  // every block's chunk is staged
    // this block's ROWS rows of the chunk, summed over the cluster in rank
    // order; all 8 peers' values of a thread's items are loaded before any
    // is added, so the remote loads overlap
    constexpr int ITEMS = ROWS * 32 / TL::threads;
    static_assert(ROWS * 32 % TL::threads == 0, "the chunk's rows split evenly");
    float4 v[ITEMS][FFN_CLUSTER];
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int i = it * TL::threads + threadIdx.x;
      const uint32_t addr = smem_u32(ex + (rank * ROWS + i / 32) * LD + 4 * (i % 32));
#pragma unroll
      for (int p = 0; p < FFN_CLUSTER; ++p) v[it][p] = ld_peer_f4(addr, p);
    }
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int i = it * TL::threads + threadIdx.x;
      float4 sum = v[it][0];
#pragma unroll
      for (int p = 1; p < FFN_CLUSTER; ++p) {
        sum.x += v[it][p].x;
        sum.y += v[it][p].y;
        sum.z += v[it][p].z;
        sum.w += v[it][p].w;
      }
      const int row = s0 + rank * ROWS + i / 32, col = 128 * c + 4 * (i % 32);
      if (row < S && col < D)  // D % 8 == 0: col + 3 < D as well
        *reinterpret_cast<float4*>(P + ((size_t)blockIdx.z * S + row) * D + col) = sum;
    }
    // The peers' chunks are read: every loaded value has been consumed by
    // the sums above before this arrival issues, so it needs no release
    // ordering (a release arrival here waits for the slab stores, which
    // was measurably slower on an H100 at the prefill shape).
    cluster_arrive_relaxed();
  }
  cluster_wait();  // no block leaves while a peer reads its shared memory
}

template <typename TL>
cudaError_t run_wgmma(const __nv_bfloat16* x, const __nv_bfloat16* wg, const __nv_bfloat16* wu,
                      const __nv_bfloat16* wd, float* partial, __nv_bfloat16* y, int S, int D,
                      int F, cudaStream_t s) {
  // TMA: 16-byte aligned bases and row strides
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wg) |
                          reinterpret_cast<uintptr_t>(wu) | reinterpret_cast<uintptr_t>(wd) |
                          reinterpret_cast<uintptr_t>(partial);
  if (D % 8 || F % 8 || bases % 16) return cudaErrorInvalidValue;
  CUtensorMap tx, tg, tu, td;
  const uint64_t x_dims[2] = {(uint64_t)D, (uint64_t)S}, x_strides[1] = {(uint64_t)D * 2};
  const uint32_t x_box[2] = {64, (uint32_t)TL::bs};
  const uint64_t w_dims[2] = {(uint64_t)F, (uint64_t)D}, w_strides[1] = {(uint64_t)F * 2};
  const uint32_t w_box[2] = {64, 64};
  const uint64_t d_dims[2] = {(uint64_t)D, (uint64_t)F}, d_strides[1] = {(uint64_t)D * 2};
  const uint32_t d_box[2] = {64, 128};
  cudaError_t e = encode_tmap_bf16(&tx, x, 2, x_dims, x_strides, x_box);
  if (e == cudaSuccess) e = encode_tmap_bf16(&tg, wg, 2, w_dims, w_strides, w_box);
  if (e == cudaSuccess) e = encode_tmap_bf16(&tu, wu, 2, w_dims, w_strides, w_box);
  if (e == cudaSuccess) e = encode_tmap_bf16(&td, wd, 2, d_dims, d_strides, d_box);
  if (e != cudaSuccess) return e;
  auto kernel = ffn_wgmma_kernel<TL>;
  e = set_smem(kernel, TL::smem);
  if (e != cudaSuccess) return e;
  const int groups = ((F + TL::bf - 1) / TL::bf + FFN_CLUSTER - 1) / FFN_CLUSTER;
  dim3 grid(FFN_CLUSTER, (S + TL::bs - 1) / TL::bs, groups);
  kernel<<<grid, TL::threads, TL::smem, s>>>(tx, tg, tu, td, partial, S, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long SD = (long long)S * D;
  const int rt = 256;
  ffn_reduce_kernel<__nv_bfloat16>
      <<<(unsigned)((SD + rt - 1) / rt), rt, 0, s>>>(partial, y, groups, SD);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- gemv --
constexpr int FG_BF = 64;        // d_ff columns a cluster owns: 8 vectors of 8 bf16
constexpr int FG_BK = 1024;      // x rows staged in shared memory at a time
constexpr int FG_THREADS = 256;  // 8 warps
constexpr int FG_U = 4;          // rows of each matrix in flight per thread
constexpr int FG_MAX_S = 8;
constexpr int FG_MAX_RG = 32;    // row groups of the down product

// Shared memory of a gemv block with MT rows of x, in floats: the x slab
// [FG_BK][MT]; the exchange [2][MT][64] (the g, then the u partials the
// peers read); h [64][MT]; a scratch for the cross-warp sums of the gate /
// up product ([8 warps][2][MT][64]) and of the down product ([threads][MT][8]).
constexpr int ffn_gemv_floats(int mt) {
  return mt * (FG_BK + 2 * FG_BF + FG_BF + FG_THREADS * 8);
}

struct FfnGemv {
  static constexpr int kind = 1, dtypes = 2;  // gemv; bf16
  static constexpr int bs = FG_MAX_S, bf = FG_BF, bk = FG_BK, tm = FG_MAX_S, tn = 8;
  static constexpr int smem = (int)sizeof(float) * ffn_gemv_floats(FG_MAX_S);  // at 8 rows
};

// bf16 -> fp32 is a 16-bit shift, two values per 32-bit word.
__device__ __forceinline__ void bf16x8_to_f32(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 ld_vec(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Grid (C, d_ff tiles); the cluster is the C blocks of x.  MT >= S rows.
// P [tiles, S, D] fp32: one slab per d_ff tile.
template <int MT, int C>
__global__ void __cluster_dims__(C, 1, 1)
    __launch_bounds__(FG_THREADS, MT <= 2 ? 3 : (MT <= 4 ? 2 : 1))
    ffn_gemv_kernel(const __nv_bfloat16* __restrict__ X, const __nv_bfloat16* __restrict__ Wg,
                    const __nv_bfloat16* __restrict__ Wu, const __nv_bfloat16* __restrict__ Wd,
                    float* __restrict__ P, int S, int D, int F) {
  extern __shared__ __align__(16) float fsmem[];
  float* xs = fsmem;                // [FG_BK][MT]
  float* ex = xs + FG_BK * MT;      // [2][MT][64]
  float* hs = ex + 2 * MT * FG_BF;  // [64][MT]
  float* red = hs + FG_BF * MT;     // scratch
  const int rank = (int)cluster_rank();
  const int tile = blockIdx.y, f0 = tile * FG_BF;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  // 1. g, u partials over this block's d_model rows: thread (warp, lane)
  // holds columns f0 + 8 (lane % 8) .. + 7 of rows warp * 4 + lane / 8
  // + 32 i of each slab (F % 8 == 0: a vector is wholly in or past d_ff)
  const int vec = lane % 8, row = warp * 4 + lane / 8;
  const bool col_ok = f0 + 8 * vec < F;
  const int kb = (int)((long long)rank * D / C), ke = (int)((long long)(rank + 1) * D / C);
  float g[MT][8], u[MT][8];
#pragma unroll
  for (int s = 0; s < MT; ++s)
#pragma unroll
    for (int j = 0; j < 8; ++j) g[s][j] = u[s][j] = 0.f;
  for (int k0 = kb; k0 < ke; k0 += FG_BK) {
    const int kn = min(FG_BK, ke - k0);
    __syncthreads();  // the previous slab is consumed
    for (int i = tid; i < kn * MT; i += FG_THREADS) {
      const int kk = i / MT, s = i % MT;
      xs[i] = s < S ? __bfloat162float(X[(size_t)s * D + k0 + kk]) : 0.f;
    }
    __syncthreads();
    if (col_ok) {
      for (int r0 = row; r0 < kn; r0 += 32 * FG_U) {
        uint4 wg[FG_U], wu[FG_U];
#pragma unroll
        for (int q = 0; q < FG_U; ++q) {
          const int r = r0 + 32 * q;
          const size_t off = (size_t)(k0 + r) * F + f0 + 8 * vec;
          wg[q] = r < kn ? ld_vec(Wg + off) : make_uint4(0u, 0u, 0u, 0u);
          wu[q] = r < kn ? ld_vec(Wu + off) : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int q = 0; q < FG_U; ++q) {
          const int r = r0 + 32 * q;
          if (r < kn) {
            float fg[8], fu[8];
            bf16x8_to_f32(wg[q], fg);
            bf16x8_to_f32(wu[q], fu);
            const float* a = xs + r * MT;
#pragma unroll
            for (int s = 0; s < MT; ++s) {
              const float am = a[s];
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                g[s][j] = fmaf(am, fg[j], g[s][j]);
                u[s][j] = fmaf(am, fu[j], u[s][j]);
              }
            }
          }
        }
      }
    }
  }
  // the warp's four row lanes (8 apart), then the 8 warps in order
#pragma unroll
  for (int s = 0; s < MT; ++s) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int off = 8; off < 32; off *= 2) {
        g[s][j] += __shfl_xor_sync(0xffffffffu, g[s][j], off);
        u[s][j] += __shfl_xor_sync(0xffffffffu, u[s][j], off);
      }
    }
  }
  if (lane < 8) {
#pragma unroll
    for (int s = 0; s < MT; ++s) {
      float* rg = red + (warp * 2 * MT + s) * FG_BF + 8 * vec;
      float* ru = rg + MT * FG_BF;
#pragma unroll
      for (int j = 0; j < 8; j += 4) {
        *reinterpret_cast<float4*>(rg + j) = make_float4(g[s][j], g[s][j + 1], g[s][j + 2], g[s][j + 3]);
        *reinterpret_cast<float4*>(ru + j) = make_float4(u[s][j], u[s][j + 1], u[s][j + 2], u[s][j + 3]);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < 2 * MT * FG_BF; e += FG_THREADS) {
    float sum = red[e];
#pragma unroll
    for (int w = 1; w < FG_THREADS / 32; ++w) sum += red[w * 2 * MT * FG_BF + e];
    ex[e] = sum;
  }

  // 2. the tile's g and u: the C partials added in rank order through
  // distributed shared memory (every block forms the same sums); h =
  // bf16(silu(g) * u) into shared memory, h[j][s] for column f0 + j
  cluster_arrive();
  cluster_wait();  // every block's partials are staged
  for (int q = tid; q < MT * FG_BF / 4; q += FG_THREADS) {
    float4 pg[C], pu[C];
#pragma unroll
    for (int p = 0; p < C; ++p) {
      pg[p] = ld_peer_f4(smem_u32(ex + 4 * q), p);
      pu[p] = ld_peer_f4(smem_u32(ex + MT * FG_BF + 4 * q), p);
    }
    float4 gs = pg[0], us = pu[0];
#pragma unroll
    for (int p = 1; p < C; ++p) {
      gs.x += pg[p].x; gs.y += pg[p].y; gs.z += pg[p].z; gs.w += pg[p].w;
      us.x += pu[p].x; us.y += pu[p].y; us.z += pu[p].z; us.w += pu[p].w;
    }
    const float gv[4] = {gs.x, gs.y, gs.z, gs.w}, uv[4] = {us.x, us.y, us.z, us.w};
    const int s = 4 * q / FG_BF, c = 4 * q % FG_BF;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = gv[i];
      hs[(c + i) * MT + s] = __bfloat162float(__float2bfloat16_rn(a / (1.f + expf(-a)) * uv[i]));
    }
  }
  // the peers' partials are read (and consumed above); this block's stay
  // in place until the last wait below
  cluster_arrive();
  __syncthreads();  // h is complete

  // 3. this block's columns of h @ Wd[f0:f0+64, :]: 16-byte vectors v0 ..
  // v1 - 1 of a row; thread (rg, vs) sums rows rg, rg + RG, ... of vectors
  // v0 + vs, v0 + vs + VS, ...; with RG > 1 groups (a thread then holds
  // one vector) the groups' sums are added in order through shared memory
  const int nvd = D / 8;
  const int v0 = (int)((long long)rank * nvd / C), v1 = (int)((long long)(rank + 1) * nvd / C);
  const int nv = v1 - v0;
  int RG = 1;
  while (RG < FG_MAX_RG && 2 * RG * nv <= FG_THREADS) RG *= 2;
  const int VS = FG_THREADS / RG, rgi = tid / VS, vs = tid % VS;
  const int rows = min(FG_BF, F - f0);
  for (int v = v0 + vs; v < v1; v += VS) {
    float acc[MT][8];
#pragma unroll
    for (int s = 0; s < MT; ++s)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[s][j] = 0.f;
    for (int j0 = rgi; j0 < rows; j0 += RG * FG_U) {
      uint4 w[FG_U];
#pragma unroll
      for (int q = 0; q < FG_U; ++q) {
        const int j = j0 + RG * q;
        w[q] = j < rows ? ld_vec(Wd + (size_t)(f0 + j) * D + 8 * v) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int q = 0; q < FG_U; ++q) {
        const int j = j0 + RG * q;
        if (j < rows) {
          float f[8];
          bf16x8_to_f32(w[q], f);
          const float* h = hs + j * MT;
#pragma unroll
          for (int s = 0; s < MT; ++s) {
            const float hv = h[s];
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[s][c] = fmaf(hv, f[c], acc[s][c]);
          }
        }
      }
    }
    if (RG == 1) {
#pragma unroll
      for (int s = 0; s < MT; ++s) {
        if (s < S) {
          float* o = P + ((size_t)tile * S + s) * D + 8 * v;
          *reinterpret_cast<float4*>(o) = make_float4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]);
          *reinterpret_cast<float4*>(o + 4) = make_float4(acc[s][4], acc[s][5], acc[s][6], acc[s][7]);
        }
      }
    } else {
#pragma unroll
      for (int s = 0; s < MT; ++s)
#pragma unroll
        for (int c = 0; c < 8; ++c) red[(tid * MT + s) * 8 + c] = acc[s][c];
    }
  }
  if (RG > 1) {
    __syncthreads();
    for (int e = tid; e < nv * MT * 8; e += FG_THREADS) {
      const int vi = e / (MT * 8), s = e / 8 % MT, c = e % 8;
      float sum = red[(vi * MT + s) * 8 + c];
      for (int r = 1; r < RG; ++r) sum += red[((r * VS + vi) * MT + s) * 8 + c];
      if (s < S) P[((size_t)tile * S + s) * D + 8 * (v0 + vi) + c] = sum;
    }
  }
  cluster_wait();  // no block leaves while a peer reads its shared memory
}

template <int MT, int C>
cudaError_t run_gemv_c(const __nv_bfloat16* x, const __nv_bfloat16* wg, const __nv_bfloat16* wu,
                       const __nv_bfloat16* wd, float* partial, __nv_bfloat16* y, int S, int D,
                       int F, cudaStream_t s) {
  auto kernel = ffn_gemv_kernel<MT, C>;
  constexpr int smem = (int)sizeof(float) * ffn_gemv_floats(MT);
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int n_f = (F + FG_BF - 1) / FG_BF;
  kernel<<<dim3(C, n_f), FG_THREADS, smem, s>>>(x, wg, wu, wd, partial, S, D, F);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long SD = (long long)S * D;
  const int rt = 256;
  ffn_reduce_kernel<__nv_bfloat16>
      <<<(unsigned)((SD + rt - 1) / rt), rt, 0, s>>>(partial, y, n_f, SD);
  return cudaGetLastError();
}

template <int MT>
cudaError_t run_gemv_mt(const __nv_bfloat16* x, const __nv_bfloat16* wg, const __nv_bfloat16* wu,
                        const __nv_bfloat16* wd, float* partial, __nv_bfloat16* y, int S, int D,
                        int F, int cluster, cudaStream_t s) {
  switch (cluster) {
    case 1: return run_gemv_c<MT, 1>(x, wg, wu, wd, partial, y, S, D, F, s);
    case 2: return run_gemv_c<MT, 2>(x, wg, wu, wd, partial, y, S, D, F, s);
    case 4: return run_gemv_c<MT, 4>(x, wg, wu, wd, partial, y, S, D, F, s);
    case 8: return run_gemv_c<MT, 8>(x, wg, wu, wd, partial, y, S, D, F, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t run_gemv(const __nv_bfloat16* x, const __nv_bfloat16* wg, const __nv_bfloat16* wu,
                     const __nv_bfloat16* wd, float* partial, __nv_bfloat16* y, int S, int D,
                     int F, int cluster, cudaStream_t s) {
  // 16-byte weight vectors: aligned bases, d_model and d_ff multiples of
  // 8; every block of a cluster keeps at least one vector of Wd's columns
  const uintptr_t bases = reinterpret_cast<uintptr_t>(wg) | reinterpret_cast<uintptr_t>(wu) |
                          reinterpret_cast<uintptr_t>(wd) | reinterpret_cast<uintptr_t>(partial);
  if (D % 8 || F % 8 || bases % 16 || S < 1 || F < 1 || cluster < 1 || cluster > D / 8)
    return cudaErrorInvalidValue;
  if (S <= 1) return run_gemv_mt<1>(x, wg, wu, wd, partial, y, S, D, F, cluster, s);
  if (S <= 2) return run_gemv_mt<2>(x, wg, wu, wd, partial, y, S, D, F, cluster, s);
  if (S <= 4) return run_gemv_mt<4>(x, wg, wu, wd, partial, y, S, D, F, cluster, s);
  if (S <= FG_MAX_S) return run_gemv_mt<8>(x, wg, wu, wd, partial, y, S, D, F, cluster, s);
  return cudaErrorInvalidValue;
}

// The compiled tile menu, by index (kernels/block_fused_ffn.py::TILES).
using F0 = FfnTile<8, 64, 64, 1, 2>;    // decode: S <= 8
using F1 = FfnTile<16, 64, 32, 2, 2>;
using F2 = FfnTile<32, 64, 32, 2, 4>;
using F3 = FfnTile<64, 64, 32, 4, 4>;
using F4 = FfnWgmma<64>;                // bf16, 9 to 64 rows
using F5 = FfnWgmma<128>;               // bf16, more rows (the prefill)
using F6 = FfnGemv;                     // bf16, decode rows: S <= 8

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
  out[0] = TL::kind; out[1] = TL::dtypes;
  out[2] = TL::bs; out[3] = TL::bf; out[4] = TL::bk;
  out[5] = TL::tm; out[6] = TL::tn; out[7] = TL::smem;
}

}  // namespace repro

extern "C" {

// `cluster`: the gemv tile's blocks a d_ff tile (1, 2, 4 or 8); the
// other tiles ignore it.
int block_fused_ffn_f32(const void* x, const void* wg, const void* wu, const void* wd,
                        void* partial, void* y, int S, int D, int F, int tile, int cluster,
                        void* stream) {
  return repro::dispatch<float>(tile, x, wg, wu, wd, partial, y, S, D, F, stream);
}

// bf16 runs every tile.
int block_fused_ffn_bf16(const void* x, const void* wg, const void* wu, const void* wd,
                         void* partial, void* y, int S, int D, int F, int tile, int cluster,
                         void* stream) {
  using bf16 = __nv_bfloat16;
  const bf16* X = static_cast<const bf16*>(x);
  const bf16* G = static_cast<const bf16*>(wg);
  const bf16* U = static_cast<const bf16*>(wu);
  const bf16* W = static_cast<const bf16*>(wd);
  float* P = static_cast<float*>(partial);
  bf16* Y = static_cast<bf16*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 4) return repro::run_wgmma<repro::F4>(X, G, U, W, P, Y, S, D, F, s);
  if (tile == 5) return repro::run_wgmma<repro::F5>(X, G, U, W, P, Y, S, D, F, s);
  if (tile == 6) return repro::run_gemv(X, G, U, W, P, Y, S, D, F, cluster, s);
  return repro::dispatch<bf16>(tile, x, wg, wu, wd, partial, y, S, D, F, stream);
}

// Writes (kind, dtypes, bs, bf, bk, tm, tn, shared-memory bytes) of menu
// entry `tile` (kind 0 simt, 1 gemv, 2 wgmma; dtypes a mask, 1 fp32, 2 bf16);
// returns the number of entries.
int block_fused_ffn_tile(int tile, int* out) {
  switch (tile) {
    case 0: repro::describe<repro::F0>(out); break;
    case 1: repro::describe<repro::F1>(out); break;
    case 2: repro::describe<repro::F2>(out); break;
    case 3: repro::describe<repro::F3>(out); break;
    case 4: repro::describe<repro::F4>(out); break;
    case 5: repro::describe<repro::F5>(out); break;
    case 6: repro::describe<repro::F6>(out); break;
    default: break;
  }
  return 7;
}

}  // extern "C"
