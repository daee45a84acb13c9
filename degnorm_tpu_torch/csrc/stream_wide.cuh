// Kernel 4 for 33 <= p <= 128 samples: the Lagrangian NMF-OA loop for wide
// genes, one thread-block CLUSTER a gene, coverage read as it is stored (raw
// int16 + scale, or float32), each block's sweeps on wide.cuh's block-level
// SYRK layout.  The C entry point stays stream.cu's dn_nmf_streamed, which
// hands p > 32 here; the instances are compiled in stream_wide_f32.cu and
// stream_wide_i16.cu, side by side.
//
// Replaces, for wide studies, the TPU kernel degnorm_tpu/ops/pallas_stream.py
// ::nmf_masked_streamed (_stream_kernel), as stream.cuh does for p <= 32,
// with the same arguments, input forms and results: a gene's columns are
// dealt to its `cl` blocks in chunks of DN_STREAM_CHUNK, round robin, up to
// its last active column; int16 + scale takes common.cuh's scaled_i16, the
// IEEE quotient, so that it gives the float32 form's bits.  Bound on this
// card: float32 operations (wide.cuh).  X stays in the global scratch (a
// block's share of X at p = 128 outgrows its shared memory, which the Gram,
// the two tile buffers and the copy stage take); the copy stage brings the
// raw int16 rows in as they are stored (2 bytes an element) and the tile
// threads divide them on the way into the tile, beside the gram threads'
// triangle.  The cluster's blocks sum their Gram partials in rank order
// through distributed shared memory between two cluster barriers (the
// double buffer of the p x p partial does not fit beside the copy stage),
// and every block runs the power step on the same sum, so u is bit-equal
// across the cluster.  A gene outside `act` returns zeros from every block
// of its
// cluster before the first barrier.
#pragma once
#include "stream.cuh"
#include "wide.cuh"

// One block's columns of a gene, runtime rows (wide.cuh's Src): local slot
// l is column ((l / CH) * cl + rank) * CH + l % CH, as in stream.cuh.
template <int PMAX, bool I16>
struct WideStreamSrc {
  using AType = typename std::conditional<I16, int16_t, float>::type;
  // dozens of tiles a block: the pipelined sweep, but at PMAX = 128, where
  // its two roles spilled registers at one block an SM
  static constexpr bool PIPE = PMAX <= 96;
  const void* F;  // the gene's (p, W) rows, float32 or int16
  const uint8_t* __restrict__ mask;
  const float* ss;  // the scales (I16) ...
  const float* rs;  // ... and their reciprocals
  float* Xg;        // the gene's (p, W) rows of the global scratch
  float* E;
  int W, rank, cl, nloc;

  __device__ __forceinline__ int col(int l) const {
    return ((l / DN_STREAM_CHUNK) * cl + rank) * DN_STREAM_CHUNK +
           (l % DN_STREAM_CHUNK);
  }
  __device__ __forceinline__ int n_local() const { return nloc; }
  __device__ __forceinline__ bool on(int l) const {
    if (l >= nloc) return false;
    const int w = col(l);
    return w < W && mask[w] != 0;
  }
  __device__ __forceinline__ float a0v(AType a, int i) const {
    if constexpr (I16) return scaled_i16(a, ss[i], rs[i]);
    return a;
  }
  __device__ __forceinline__ float a0(int l, int i) const {
    return a0v(((const AType*)F)[(size_t)i * W + col(l)], i);
  }
  // the copy stage's view: a tile's columns l0 .. l0 + 63 lie in one chunk
  // (DN_STREAM_CHUNK is a multiple of the tile), contiguous in memory,
  // 16-byte aligned when W is a multiple of 8
  __device__ __forceinline__ bool vec() const { return W % 8 == 0; }
  __device__ __forceinline__ int valid_cols(int l0) const {
    const int left = W - col(l0);
    return left < 0 ? 0 : left < DN_WIDE_TC ? left : DN_WIDE_TC;
  }
  __device__ __forceinline__ const float* xrow(int i, int l0) const {
    return Xg + (size_t)i * W + col(l0);
  }
  __device__ __forceinline__ const AType* arow(int i, int l0) const {
    return (const AType*)F + (size_t)i * W + col(l0);
  }
  __device__ __forceinline__ float x(int l, int i) const {
    return Xg[(size_t)i * W + col(l)];
  }
  __device__ __forceinline__ void set_x(int l, int i, float v) const {
    Xg[(size_t)i * W + col(l)] = v;
  }
  __device__ __forceinline__ void store_e(int l, float e) const {
    if (l >= nloc) return;
    const int w = col(l);
    if (w < W) E[w] = e;
  }
};

// The cluster's reduction: every block's Gram partial into its w.B, one
// cluster barrier, each gram thread sums its entries of the triangle (and
// each diagonal tile thread its entry) over the ranks in rank order, a
// second barrier (no block's w.B is read any more), the sum and its mirror
// into w.B.  A cluster of one is a block barrier.
struct WideClusterRed {
  int cl;
  // the synchronous sweep's full register tile (PMAX = 128)
  template <int PMAX>
  __device__ __forceinline__ void reduce(WideGram<PMAX>& g,
                                         WideWork<PMAX>& w) const {
    constexpr int R = WideShape<PMAX>::R, LD = WideShape<PMAX>::LD;
    g.store(w.B);
    if (cl == 1) {
      __syncthreads();
      return;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    g.zero();
    for (int k = 0; k < cl; ++k) {
      const float* Bk = cluster.map_shared_rank(w.B, k);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int s = 0; s < R; ++s)
          g.acc[r][s] += Bk[(g.ty * R + r) * LD + g.tx * R + s];
    }
    cluster.sync();
    g.store(w.B);
    __syncthreads();
  }
  // the pipelined sweep's triangle
  template <int PMAX>
  __device__ __forceinline__ void reduce(WideTri<PMAX>& tri,
                                         WideDiag<PMAX>& dg,
                                         WideWork<PMAX>& w) const {
    constexpr int R = WideShape<PMAX>::R, LD = WideShape<PMAX>::LD;
    wide_tri_store(tri, dg, w);
    if (cl == 1) return;
    const bool gram = threadIdx.x < DN_WIDE_GRAM_THREADS;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (gram) tri.zero();
    float d = 0.f;
    for (int k = 0; k < cl; ++k) {
      const float* Bk = cluster.map_shared_rank(w.B, k);
      if (gram) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int s = 0; s < R; ++s) {
            int i, j;
            tri.entry(r, s, i, j);
            tri.acc[r][s] += Bk[i * LD + j];
          }
      }
      if (dg.row >= 0) d += Bk[dg.row * LD + dg.row];
    }
    dg.acc = d;
    cluster.sync();
    wide_tri_store(tri, dg, w);
  }
};

template <int PMAX, bool I16>
__global__ void __launch_bounds__(DN_WIDE_THREADS, dn_wide_core_blocks<PMAX>())
    nmf_stream_wide_kernel(const void* __restrict__ F,
                           const uint8_t* __restrict__ mask,
                           const uint8_t* __restrict__ act,
                           const float* __restrict__ scale,
                           const float* __restrict__ u0, float* Xscratch,
                           float* __restrict__ K, float* __restrict__ E,
                           float* __restrict__ u_out, int p, int W,
                           int nmf_iter, int power_cold, int power_warm,
                           int warm_plain, int cl) {
  constexpr int CH = DN_STREAM_CHUNK;
  __shared__ float s_scale[2 * PMAX];  // scales, then their reciprocals
  __shared__ int s_ncols;              // last active column of the gene + 1
  extern __shared__ float4 dyn4[];     // wide.cuh's work space

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cl > 1 ? (int)cluster.block_rank() : 0;
  const size_t g = blockIdx.x / cl;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const uint8_t* mg = mask + g * W;
  float* Eg = E + g * W;

  // act[g] is the same for the whole cluster: all its blocks leave here,
  // before any barrier
  if (act != nullptr && act[g] == 0) {
    if (rank == 0 && tid < p) {
      K[g * p + tid] = 0.f;
      u_out[g * p + tid] = 0.f;
    }
    for (int w = rank * nt + tid; w < W; w += cl * nt) Eg[w] = 0.f;
    return;
  }

  WideWork<PMAX> wk;
  wk.init((float*)dyn4);
  if (tid == 0) s_ncols = 0;
  if (tid < PMAX) {
    const float sv = (I16 && tid < p) ? scale[tid] : 1.0f;
    s_scale[tid] = sv;
    s_scale[PMAX + tid] = 1.0f / sv;
    wk.u[tid] = tid < p ? (u0 != nullptr ? u0[g * p + tid]
                                         : 1.0f / sqrtf((float)p))
                        : 0.f;
  }
  __syncthreads();
  {
    int last = 0;
    for (int w = tid; w < W; w += nt)
      if (mg[w] != 0) last = w + 1;
    last = __reduce_max_sync(DN_FULL, last);
    if (lane == 0 && last > 0) atomicMax(&s_ncols, last);
  }
  __syncthreads();

  // this block's chunks: rank, rank + cl, ... below the gene's last one
  const int nch = (s_ncols + CH - 1) / CH;
  WideStreamSrc<PMAX, I16> src;
  src.F = I16 ? (const void*)((const int16_t*)F + g * p * W)
              : (const void*)((const float*)F + g * p * W);
  src.mask = mg;
  src.ss = s_scale;
  src.rs = s_scale + PMAX;
  src.Xg = Xscratch + g * p * W;
  src.E = Eg;
  src.W = W;
  src.rank = rank;
  src.cl = cl;
  src.nloc = (rank < nch ? (nch - rank + cl - 1) / cl : 0) * CH;

  float s;
  wide_core<PMAX, false>(src, WideClusterRed{cl}, wk, p, s, nmf_iter,
                         power_cold, power_warm, warm_plain);

  // E past the dealt chunks; K and u from the first block
  for (int w = nch * CH + rank * nt + tid; w < W; w += cl * nt) Eg[w] = 0.f;
  if (rank == 0 && tid < p) {
    K[g * p + tid] = wk.u[tid] * s;
    u_out[g * p + tid] = wk.u[tid];
  }
}

template <bool I16>
int launch_stream_wide(const StreamArgs& a) {
  if (a.threads != DN_WIDE_THREADS || a.p < DN_WIDE_MIN_P ||
      a.p > DN_WIDE_MAX_P)
    return (int)cudaErrorInvalidValue;
  if (a.G == 0) return 0;
#define CALL(PM)                                                              \
  do {                                                                        \
    auto kern = nmf_stream_wide_kernel<PM, I16>;                              \
    constexpr bool pipe = WideStreamSrc<PM, I16>::PIPE;                       \
    const size_t dyn = sizeof(float) * (pipe ? wide_work_floats<PM>()         \
                                             : wide_sync_floats<PM>());       \
    cudaError_t e = cudaFuncSetAttribute(                                     \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);         \
    if (e != cudaSuccess) return (int)e;                                      \
    cudaLaunchConfig_t cfg = {};                                              \
    cfg.gridDim = dim3((unsigned)a.G * a.cl, 1, 1);                           \
    cfg.blockDim = dim3(DN_WIDE_THREADS, 1, 1);                               \
    cfg.dynamicSmemBytes = dyn;                                               \
    cfg.stream = a.st;                                                        \
    cudaLaunchAttribute attr[1];                                              \
    attr[0].id = cudaLaunchAttributeClusterDimension;                         \
    attr[0].val.clusterDim.x = a.cl;                                          \
    attr[0].val.clusterDim.y = 1;                                             \
    attr[0].val.clusterDim.z = 1;                                             \
    cfg.attrs = attr;                                                         \
    cfg.numAttrs = 1;                                                         \
    e = cudaLaunchKernelEx(&cfg, kern, a.F, a.mask, a.act, a.scale, a.u0,     \
                           a.X, a.K, a.E, a.u, a.p, a.W, a.nmf_iter,          \
                           a.power_cold, a.power_warm, a.warm_plain, a.cl);   \
    if (e != cudaSuccess) return (int)e;                                      \
  } while (0)
  DN_DISPATCH_WIDE_P(a.p, CALL);
#undef CALL
  return (int)cudaGetLastError();
}
