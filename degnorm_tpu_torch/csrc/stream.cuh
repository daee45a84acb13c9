// Kernel 4: the Lagrangian NMF-OA loop for wide genes, one thread-block
// CLUSTER per gene, coverage read as it is stored (raw int16 or float32).
//
// Replaces the TPU kernel degnorm_tpu/ops/pallas_stream.py::
// nmf_masked_streamed (_stream_kernel).  Computes what nmf.cu computes
// (A0 = F * mask, cold rank-1 from the p x p Gram, nmf_iter merged sweeps
// X <- max(X - step (u (x) u^T X - A0), A0) + Gram of the new X, a power
// step per sweep, K = u s, E = X^T u / s) for buckets outside the resident
// kernels' gate: few genes, each p x W of 0.5 MB and more.  With `scale`
// the input is the engine's raw coverage and a column's value is
// (float)raw / scale[i], then zero where the mask is off, equal bit for bit
// to reading the pre-adjusted float32 form.
//
// What bounds it on this card: by count float32 operations (about
// nmf_iter (p(p+1) + 8p) per active column against 2p or 4p bytes read
// once); in practice the latency of a sweep (common.cuh) and, with X in
// device memory, its bytes: the genes in flight of a whole bucket overflow
// the L2 cache.  The design, beside common.cuh's sweep:
//   * Geometry is the launch's, not the kernel's: `cl` blocks a gene (a
//     cluster, 1 to 8) of `threads` threads, chosen by shape in
//     ops/cuda_stream.py.  A cluster pays a barrier and p(p+1)/2 remote reads
//     a block every sweep, so a gene gets the smallest one that leaves a
//     thread no more than 256 / p column slots.  Columns are dealt to the
//     blocks in chunks of DN_STREAM_CHUNK, round robin, and only the chunks
//     up to the gene's last active column are dealt: padding costs nothing.
//   * The input form is a template parameter: no sweep branches on it.  Two
//     forms reach the kernel, finished float32 coverage and raw int16 + scale
//     (int16 without scales is divided by ones; raw float32 with scales
//     saves no bytes over the finished form and is not taken).  For
//     int16 + scale the quotient comes from the sample's reciprocal, hoisted
//     out of the sweeps, by two Newton corrections with exact residuals
//     (scaled_i16): q = a r, twice e = fma(-q, s, a), q = fma(e, r, q).  With
//     r the correctly rounded 1 / s and the first corrected q faithful, the
//     second is the correctly rounded a / s (Markstein's theorem), i.e. the
//     IEEE divide; chip_smoke.py checks all 65,536 numerators against it.
//   * A block keeps its share of X, and then of the input as it arrives (2
//     bytes an int16 element), in its shared memory, as many column slots of
//     each as fit, so that the sweeps leave device memory alone: a sweep
//     that fetches a column from there waits on it with few warps to hide
//     behind.  The slots past what fits keep X in a global scratch tensor
//     and read the input again each sweep; a thread reads and rewrites only
//     its own columns, so neither needs a barrier.
//   * Gram: the warps' partials (common.cuh) are summed in a fixed order into
//     the block's partial, the cluster's blocks read each other's through
//     distributed shared memory in rank order after ONE cluster barrier, and
//     every warp of every block runs the power step itself on identical
//     numbers, so u is bit-equal across the cluster with no broadcast, and
//     two runs with one geometry give the same bits.  The blocks' partials
//     are double-buffered by sweep parity.
//   * A gene outside `act` returns zeros from every block of its cluster
//     before the first barrier.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define DN_STREAM_CHUNK 128
#define DN_STREAM_MAX_CLUSTER 8  // the largest portable cluster

// One block's columns of a gene.  Local slot l is column
// ((l / CH) * cl + rank) * CH + l % CH of the gene.  I16: the input is raw
// int16 coverage divided by `scale`; else finished float32 coverage.
template <int PMAX, bool I16, bool FULL>
struct StreamSrc {
  // the scales and their reciprocals: registers for p <= 8, else shared
  // memory (`ss`: PMAX scales, then PMAX reciprocals)
  static constexpr bool SREG = PMAX <= 8;
  static constexpr int NS = (I16 && SREG) ? PMAX : 1;
  const float* ss;
  const void* F;  // (p, W) rows of this gene, float32 or int16
  const uint8_t* __restrict__ mask;
  // The block's slots below xcap keep X in its shared memory, (p, xcap)
  // floats at Xs; the others in the gene's (p, W) rows of the global scratch
  // Xg.  The slots below acap keep their input as it arrived, (p, acap)
  // elements at As, written by the cold sweep; the others read it from device
  // memory again each sweep.  Both caps are multiples of 32 (a warp's slots
  // are on one side).
  float* Xs;
  float* Xg;
  void* As;
  float* E;
  int p, W, rank, cl, nloc, xcap, acap;
  float sc[NS], rc[NS];

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
  __device__ __forceinline__ float from_i16(int16_t raw, int i) const {
    return scaled_i16(raw, SREG ? sc[i % NS] : ss[i],
                      SREG ? rc[i % NS] : ss[PMAX + i]);
  }
  // A0 of the cold sweep: from device memory, leaving the block's copy
  __device__ __forceinline__ void load_a0(int l, float (&a)[PMAX]) const {
    const int w = col(l);
    const bool keep = l < acap;
#pragma unroll
    for (int i = 0; i < PMAX; ++i) {
      float v = 0.f;
      if (DN_ROW(i)) {
        const size_t at = (size_t)i * W + w;
        if (I16) {
          const int16_t raw = ((const int16_t*)F)[at];
          if (keep) ((int16_t*)As)[(size_t)i * acap + l] = raw;
          v = from_i16(raw, i);
        } else {
          v = ((const float*)F)[at];
          if (keep) ((float*)As)[(size_t)i * acap + l] = v;
        }
      }
      a[i] = v;
    }
  }
  __device__ __forceinline__ float a_at(int l, int i) const {
    if (!DN_ROW(i)) return 0.f;
    if (l < acap) {
      if (I16) return from_i16(((const int16_t*)As)[(size_t)i * acap + l], i);
      return ((const float*)As)[(size_t)i * acap + l];
    }
    const size_t at = (size_t)i * W + col(l);
    if (I16) return from_i16(((const int16_t*)F)[at], i);
    return ((const float*)F)[at];
  }
  __device__ __forceinline__ void load_x(int l, float (&x)[PMAX]) const {
    const bool loc = l < xcap;
    const float* base = loc ? Xs : Xg;
    const size_t stride = loc ? xcap : W;
    const int at = loc ? l : col(l);
#pragma unroll
    for (int i = 0; i < PMAX; ++i)
      x[i] = DN_ROW(i) ? base[i * stride + at] : 0.f;
  }
  __device__ __forceinline__ void store_x(int l, const float (&x)[PMAX]) const {
    const bool loc = l < xcap;
    float* base = loc ? Xs : Xg;
    const size_t stride = loc ? xcap : W;
    const int at = loc ? l : col(l);
#pragma unroll
    for (int i = 0; i < PMAX; ++i)
      if (DN_ROW(i)) base[i * stride + at] = x[i];
  }
  __device__ __forceinline__ void store_e(int l, float e) const {
    if (l >= nloc) return;
    const int w = col(l);
    if (w < W) E[w] = e;
  }
};

// Warps -> block -> cluster reduction of the Gram and the power step.
template <int PMAX>
struct StreamRed {
  static constexpr int NG = PMAX * (PMAX + 1) / 2;
  float part[dn_max_warps<PMAX>()][NG];  // the warps' partials
  float cpart[2][NG];                    // this block's partial, by parity
  int cl;

  template <class G>
  __device__ __forceinline__ float refit(G& gram, int parity, float u,
                                         int n_squared, int n_plain,
                                         bool finish, float& s) {
    const int tid = threadIdx.x, nt = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
    cg::cluster_group cluster = cg::this_cluster();
    gram.flush(part[warp], lane);
    __syncthreads();
    for (int k = tid; k < NG; k += nt) {
      float t = 0.f;
      for (int w = 0; w < nw; ++w) t += part[w][k];
      cpart[parity][k] = t;
    }
    // every block's partial is written and visible
    if (cl > 1)
      cluster.sync();
    else
      __syncthreads();
    float row[PMAX];
#pragma unroll
    for (int j = 0; j < PMAX; ++j) {
      const int a = lane < j ? lane : j, b = lane < j ? j : lane;
      const int idx = lane < PMAX ? packed_index<PMAX>(a, b) : 0;
      float t = 0.f;
      if (cl > 1) {
        for (int r = 0; r < cl; ++r)
          t += cluster.map_shared_rank(&cpart[parity][0], r)[idx];
      } else {
        t = cpart[parity][idx];
      }
      row[j] = lane < PMAX ? t : 0.f;
    }
    return power_refit<PMAX>(row, u, n_squared, n_plain, finish, s);
  }
};

template <int PMAX, bool I16, bool FULL>
__global__ void __launch_bounds__(32 * dn_max_warps<PMAX>(), 1)
    nmf_streamed_kernel(const void* __restrict__ F,
                        const uint8_t* __restrict__ mask,
                        const uint8_t* __restrict__ act,
                        const float* __restrict__ scale,
                        const float* __restrict__ u0, float* Xscratch,
                        float* __restrict__ K, float* __restrict__ E,
                        float* __restrict__ u_out, int p, int W, int nmf_iter,
                        int power_cold, int power_warm, int warm_plain,
                        int cl, int x_floats) {
  constexpr int CH = DN_STREAM_CHUNK;
  __shared__ StreamRed<PMAX> red;
  __shared__ float s_scale[2 * PMAX];  // scales, then their reciprocals
  __shared__ int s_ncols;  // last active column of the gene + 1
  // Gram tiles (p >= 16), then x_floats floats for X and the input
  extern __shared__ float tiles[];

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

  if (tid == 0) {
    s_ncols = 0;
    red.cl = cl;
  }
  if (tid < PMAX) {
    const float sv = (I16 && tid < p) ? scale[tid] : 1.0f;
    s_scale[tid] = sv;
    s_scale[PMAX + tid] = 1.0f / sv;
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
  StreamSrc<PMAX, I16, FULL> src;
  src.F = I16 ? (const void*)((const int16_t*)F + g * p * W)
              : (const void*)((const float*)F + g * p * W);
  src.mask = mg;
  src.E = Eg;
  src.p = p;
  src.W = W;
  src.rank = rank;
  src.cl = cl;
  src.nloc = (rank < nch ? (nch - rank + cl - 1) / cl : 0) * CH;
  // shared memory first to X (read and written every sweep), then to the
  // input (read every sweep), as many slots of each as fit, in whole warps
  {
    float* room = tiles + gram_tile_floats<PMAX>(nt >> 5);
    const int fit_x = (x_floats / p) & ~31;
    src.xcap = src.nloc < fit_x ? src.nloc : fit_x;
    const int left = x_floats - src.xcap * p;
    const int fit_a = ((I16 ? 2 * left : left) / p) & ~31;
    src.acap = src.nloc < fit_a ? src.nloc : fit_a;
    src.Xs = room;
    src.As = room + (size_t)src.xcap * p;
    src.Xg = Xscratch + g * p * W;
  }
  src.ss = s_scale;
#pragma unroll
  for (int i = 0; i < StreamSrc<PMAX, I16, FULL>::NS; ++i) {
    src.sc[i] = s_scale[i];
    src.rc[i] = s_scale[PMAX + i];
  }

  float u_lane = 0.f;
  if (lane < p)
    u_lane = u0 != nullptr ? u0[g * p + lane] : 1.0f / sqrtf((float)p);
  float s;
  nmf_core<PMAX>(src, red, tiles, u_lane, s, nmf_iter, power_cold, power_warm,
                 warm_plain);

  // E past the dealt chunks; K and u from the first block
  for (int w = nch * CH + rank * nt + tid; w < W; w += cl * nt) Eg[w] = 0.f;
  if (rank == 0 && tid < p) {
    K[g * p + tid] = u_lane * s;
    u_out[g * p + tid] = u_lane;
  }
  // no block may leave while another can still read its Gram partial
  if (cl > 1) cluster.sync();
}

// Floats of shared memory a block is given for X and its copy of the input:
// what its largest share of a gene needs (whole chunks, dealt round robin),
// or what the card leaves a block beside the kernel's static part and its
// Gram tiles.  The kernel decides per block what fits: X and the input, X
// alone, or neither (X then stays in the global scratch).
template <class Kernel>
static cudaError_t stream_x_floats(Kernel kernel, size_t tile_bytes, int p,
                                   int W, int cl, size_t itemsize, int* out) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  int dev = 0, optin = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  const long long room =
      ((long long)optin - (long long)fa.sharedSizeBytes - (long long)tile_bytes) /
      (long long)sizeof(float);
  const long long chunks = (W + DN_STREAM_CHUNK - 1) / DN_STREAM_CHUNK;
  const long long share = (chunks + cl - 1) / cl * DN_STREAM_CHUNK;
  const long long want =
      share * p + (share * p * (long long)itemsize + 3) / 4;
  const long long got = want < room ? want : room;
  *out = got > 0 ? (int)got : 0;
  return cudaSuccess;
}

template <int PM, bool I16, bool FULL>
static int launch_streamed(const void* F, const uint8_t* mask,
                           const uint8_t* act, const float* scale,
                           const float* u0, float* X, float* K, float* E,
                           float* u, int G, int p, int W, int nmf_iter,
                           int power_cold, int power_warm, int warm_plain,
                           int cl, int threads, cudaStream_t st) {
  if (threads > 32 * dn_max_warps<PM>()) return (int)cudaErrorInvalidValue;
  const size_t tile_bytes = sizeof(float) * gram_tile_floats<PM>(threads / 32);
  int x_floats = 0;
  cudaError_t e = stream_x_floats(nmf_streamed_kernel<PM, I16, FULL>,
                                  tile_bytes, p, W, cl,
                                  I16 ? sizeof(int16_t) : sizeof(float),
                                  &x_floats);
  if (e != cudaSuccess) return (int)e;
  const size_t dyn = tile_bytes + sizeof(float) * (size_t)x_floats;
  e = cudaFuncSetAttribute(nmf_streamed_kernel<PM, I16, FULL>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)dyn);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)G * cl, 1, 1);  // whole clusters, one a gene
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, nmf_streamed_kernel<PM, I16, FULL>, F,
                                 mask, act, scale, u0, X, K, E, u, p, W,
                                 nmf_iter, power_cold, power_warm, warm_plain,
                                 cl, x_floats);
}

// The arguments of a launch, handed from the C entry point (stream.cu) to
// the translation unit of the p's template instance (stream_p*.cu: one file
// an instance, so that they compile side by side).
struct StreamArgs {
  const void* F;  // int16 with `scale`, else float32
  const uint8_t* mask;
  const uint8_t* act;
  const float* scale;
  const float* u0;
  float* X;
  float* K;
  float* E;
  float* u;
  int G, p, W, nmf_iter, power_cold, power_warm, warm_plain, cl, threads;
  cudaStream_t st;
  float* ws = nullptr;  // p > 128: the panel instance's workspace (stream.cu)
  int ws_slots = 0;
};

// One translation unit an (PMAX, input form): stream_p<PMAX>_<f32|i16>.cu.
template <int PM, bool I16>
static int launch_streamed_full(const StreamArgs& a) {
#define DN_STREAM_ARGS                                                      \
  a.F, a.mask, a.act, a.scale, a.u0, a.X, a.K, a.E, a.u, a.G, a.p, a.W,      \
      a.nmf_iter, a.power_cold, a.power_warm, a.warm_plain, a.cl, a.threads, \
      a.st
  if (a.p == PM) return launch_streamed<PM, I16, true>(DN_STREAM_ARGS);
  return launch_streamed<PM, I16, false>(DN_STREAM_ARGS);
#undef DN_STREAM_ARGS
}

// [PMAX index][int16 form]
int dn_stream_p4_f32(const StreamArgs& a);
int dn_stream_p4_i16(const StreamArgs& a);
int dn_stream_p8_f32(const StreamArgs& a);
int dn_stream_p8_i16(const StreamArgs& a);
int dn_stream_p16_f32(const StreamArgs& a);
int dn_stream_p16_i16(const StreamArgs& a);
int dn_stream_p32_f32(const StreamArgs& a);
int dn_stream_p32_i16(const StreamArgs& a);
// the instances for 33 <= p <= 128 (stream_wide.cuh: stream_wide_f32.cu,
// stream_wide_i16.cu), whose block is DN_WIDE_THREADS threads
int dn_stream_wide_f32(const StreamArgs& a);
int dn_stream_wide_i16(const StreamArgs& a);
// the instances for p > 128 (stream_panel.cu: panel.cuh's cores, a cluster
// or a block a gene), both forms
int dn_stream_panel(const StreamArgs& a);
// p > DN_PCL_MAX_P_STREAM: the phased layout (stream_phase.cu)
int dn_stream_phase(const StreamArgs& a);
