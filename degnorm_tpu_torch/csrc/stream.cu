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
// (float)raw / scale[i], then zero where the mask is off: a true IEEE divide
// in that order, so the result equals reading the pre-adjusted float32 form
// bit for bit.
//
// Design.  One block per gene would leave a few hundred wide genes on a few
// of the 132 SMs, each running its 50 sweeps alone.  So a gene is spread
// over a cluster of DN_STREAM_CLUSTER blocks.
//   * Columns are dealt to the blocks in chunks of DN_STREAM_CHUNK, round
//     robin, and only the chunks up to the gene's last active column are
//     dealt: padding costs nothing and the blocks' shares of the active
//     columns are even wherever the coverage is high.
//   * X lives in a global scratch tensor, as in nmf.cu: a thread reads and
//     rewrites only its own columns, so the sweeps need no barrier for it and
//     the working set of the genes in flight stays in L2.
//   * Gram: per thread p(p+1)/2 partial sums in registers, warp shuffles,
//     a fixed-order sum over the block's warps, then a fixed-order sum over
//     the cluster's blocks read through distributed shared memory.  Every
//     block then runs the p x p power step itself on identical numbers, so u
//     is bit-equal across the cluster with no broadcast, and two runs give
//     the same bits.  The blocks' partials are double-buffered by sweep
//     parity, which leaves ONE cluster barrier a sweep.
//   * A gene outside `act` returns zeros from every block of its cluster
//     before the first barrier.
//
// Bound on this card: float32 operations, as nmf.cu (about
// nmf_iter (p(p+1) + 8p) per active column against 2p or 4p bytes read
// once); with raw input each sweep adds p IEEE divides a column.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define DN_STREAM_CHUNK 128
#define DN_STREAM_CLUSTER 8  // blocks a gene; the largest portable cluster
#define DN_STREAM_MAX_WARPS 16

template <int PMAX>
struct StreamSmem {
  NmfSmem<PMAX, DN_STREAM_MAX_WARPS> nmf;
  float cpart[2][NmfSmem<PMAX>::NG];  // this block's Gram partial, by parity
  float scale[PMAX];
  int ncols;  // last active column of the gene + 1
};

// Sum the per-thread Gram partials over the block, then over the cluster,
// into ss.nmf.red (identical in every block), and refit u from it.
template <int PMAX>
__device__ __forceinline__ void cluster_refit(
    StreamSmem<PMAX>& ss, cg::cluster_group& cluster,
    const float (&acc)[NmfSmem<PMAX>::NG], int parity, int n_squared,
    int n_plain, bool finish) {
  constexpr int NG = NmfSmem<PMAX>::NG;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
#pragma unroll
  for (int k = 0; k < NG; ++k) {
    const float v = warp_sum(acc[k]);
    if (lane == 0) ss.nmf.part[warp * NG + k] = v;
  }
  __syncthreads();
  for (int k = tid; k < NG; k += nt) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += ss.nmf.part[w * NG + k];
    ss.cpart[parity][k] = s;
  }
  cluster.sync();  // every block's partial is written and visible
  for (int k = tid; k < NG; k += nt) {
    float s = 0.f;
    for (int r = 0; r < DN_STREAM_CLUSTER; ++r)
      s += cluster.map_shared_rank(&ss.cpart[parity][0], r)[k];
    ss.nmf.red[k] = s;
  }
  __syncthreads();
  if (warp == 0) warp0_refit<PMAX>(ss.nmf, n_squared, n_plain, finish);
  __syncthreads();
}

template <int PMAX>
__global__ void __cluster_dims__(DN_STREAM_CLUSTER, 1, 1)
    __launch_bounds__(32 * DN_STREAM_MAX_WARPS)
    nmf_streamed_kernel(const void* __restrict__ F, int f_is_i16,
                        const uint8_t* __restrict__ mask,
                        const uint8_t* __restrict__ act,
                        const float* __restrict__ scale,
                        const float* __restrict__ u0, float* Xscratch,
                        float* __restrict__ K, float* __restrict__ E,
                        float* __restrict__ u_out, int p, int W, int nmf_iter,
                        int power_cold, int power_warm, int warm_plain) {
  constexpr int NG = NmfSmem<PMAX>::NG;
  constexpr int CH = DN_STREAM_CHUNK, CL = DN_STREAM_CLUSTER;
  __shared__ StreamSmem<PMAX> ss;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const size_t g = blockIdx.x / CL;
  const int tid = threadIdx.x, nt = blockDim.x;
  const uint8_t* mg = mask + g * W;
  float* Eg = E + g * W;

  // act[g] is the same for the whole cluster: all its blocks leave here,
  // before any barrier
  if (act != nullptr && act[g] == 0) {
    if (rank == 0 && tid < p) {
      K[g * p + tid] = 0.f;
      u_out[g * p + tid] = 0.f;
    }
    for (int w = rank * nt + tid; w < W; w += CL * nt) Eg[w] = 0.f;
    return;
  }

  if (tid == 0) ss.ncols = 0;
  if (tid < PMAX) {
    const float start = u0 != nullptr ? (tid < p ? u0[g * p + tid] : 0.f)
                                      : 1.0f / sqrtf((float)p);
    ss.nmf.u[tid] = tid < p ? start : 0.f;
    ss.scale[tid] = (scale != nullptr && tid < p) ? scale[tid] : 1.0f;
  }
  __syncthreads();
  {
    int last = 0;
    for (int w = tid; w < W; w += nt)
      if (mg[w] != 0) last = w + 1;
    last = __reduce_max_sync(DN_FULL, last);
    if ((tid & 31) == 0 && last > 0) atomicMax(&ss.ncols, last);
  }
  __syncthreads();

  // this block's chunks: rank, rank + CL, ... below the gene's last one
  const int nch = (ss.ncols + CH - 1) / CH;
  const int nloc = (rank < nch ? (nch - rank + CL - 1) / CL : 0) * CH;
  float* Xg = Xscratch + g * p * W;
  const bool i16 = f_is_i16 != 0, divide = scale != nullptr;
  const float* F32 = (const float*)F + g * p * W;
  const int16_t* F16 = (const int16_t*)F + g * p * W;
  const float step =
      nmf_iter > 0 ? (float)(1.0 / sqrt((double)nmf_iter)) : 0.f;

#define DN_COL(l) ((((l) / CH) * CL + rank) * CH + ((l) % CH))
#define DN_A0(i, w)                                                      \
  ((i) < p ? (divide ? (i16 ? (float)F16[(size_t)(i) * W + (w)]          \
                            : F32[(size_t)(i) * W + (w)]) / ss.scale[i]  \
                     : (i16 ? (float)F16[(size_t)(i) * W + (w)]          \
                            : F32[(size_t)(i) * W + (w)]))               \
           : 0.f)

  float acc[NG];
  float u[PMAX];

  // cold sweep: X = A0, Gram of A0
#pragma unroll
  for (int k = 0; k < NG; ++k) acc[k] = 0.f;
  for (int l = tid; l < nloc; l += nt) {
    const int w = DN_COL(l);
    if (w >= W || mg[w] == 0) continue;  // never read again
    float x[PMAX];
#pragma unroll
    for (int i = 0; i < PMAX; ++i) {
      x[i] = DN_A0(i, w);
      if (i < p) Xg[(size_t)i * W + w] = x[i];
    }
    gram_accumulate<PMAX>(x, acc);
  }
  cluster_refit<PMAX>(ss, cluster, acc, 0, power_cold, 0, nmf_iter == 0);

  // merged sweeps: v = u^T X, multiplier update, Gram of the new X
  for (int it = 0; it < nmf_iter; ++it) {
#pragma unroll
    for (int i = 0; i < PMAX; ++i) u[i] = ss.nmf.u[i];
#pragma unroll
    for (int k = 0; k < NG; ++k) acc[k] = 0.f;
    for (int l = tid; l < nloc; l += nt) {
      const int w = DN_COL(l);
      if (w >= W || mg[w] == 0) continue;  // column stays exactly zero
      float x[PMAX], a[PMAX];
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < PMAX; ++i) {
        x[i] = i < p ? Xg[(size_t)i * W + w] : 0.f;
        a[i] = DN_A0(i, w);
        v = fmaf(x[i], u[i], v);
      }
#pragma unroll
      for (int i = 0; i < PMAX; ++i) {
        x[i] = fmaxf(x[i] - step * (u[i] * v - a[i]), a[i]);
        if (i < p) Xg[(size_t)i * W + w] = x[i];
      }
      gram_accumulate<PMAX>(x, acc);
    }
    cluster_refit<PMAX>(ss, cluster, acc, (it + 1) & 1, power_warm,
                        warm_plain, it == nmf_iter - 1);
  }

  // finish: E = X^T u / (s + eps) on this block's columns, zeros elsewhere
#pragma unroll
  for (int i = 0; i < PMAX; ++i) u[i] = ss.nmf.u[i];
  const float s = ss.nmf.s;
  for (int l = tid; l < nloc; l += nt) {
    const int w = DN_COL(l);
    if (w >= W) continue;
    float e = 0.f;
    if (mg[w] != 0) {
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < PMAX; ++i)
        v = fmaf(i < p ? Xg[(size_t)i * W + w] : 0.f, u[i], v);
      e = v / (s + DN_EPS);
    }
    Eg[w] = e;
  }
  for (int w = nch * CH + rank * nt + tid; w < W; w += CL * nt) Eg[w] = 0.f;
  if (rank == 0 && tid < p) {
    K[g * p + tid] = ss.nmf.K[tid];
    u_out[g * p + tid] = ss.nmf.u[tid];
  }
#undef DN_COL
#undef DN_A0
  // no block may leave while another can still read its Gram partial
  cluster.sync();
}

// X: (G, p, W) float32 scratch.  threads: a multiple of 32, at most
// 32 * DN_STREAM_MAX_WARPS.
extern "C" int dn_nmf_streamed(const void* F, int f_is_i16,
                               const uint8_t* mask, const uint8_t* act,
                               const float* scale, const float* u0, float* X,
                               float* K, float* E, float* u, int G, int p,
                               int W, int nmf_iter, int power_cold,
                               int power_warm, int warm_plain, int threads,
                               void* stream) {
  if (threads % 32 != 0 || threads < 32 ||
      threads > 32 * DN_STREAM_MAX_WARPS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // the cluster size is the kernel's own (__cluster_dims__): the grid is a
  // whole number of clusters, one per gene
#define CALL(PM)                                                            \
  nmf_streamed_kernel<PM><<<G * DN_STREAM_CLUSTER, threads, 0, st>>>(       \
      F, f_is_i16, mask, act, scale, u0, X, K, E, u, p, W, nmf_iter,        \
      power_cold, power_warm, warm_plain)
  DN_DISPATCH_P(p, CALL);
#undef CALL
  return (int)cudaGetLastError();
}
