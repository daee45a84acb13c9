// Kernel 2: ratio-SVD row sums, one gene a cluster of 1 to 8 thread blocks,
// coverage read as it is stored (raw int16 or float32).
//
// Replaces the TPU kernel degnorm_tpu/ops/pallas_nmf.py::ratio_rowsums_pallas
// (_ratio_kernel).  Computes, per gene: A0 = F * mask, one cold rank-1
// (K, E), est = max(K (x) E, A0), and the row sums of A0 and of est — the
// inputs of the DegNorm initialisation (reference nmf.py:109-121,522-526).
//
// Bound on this card: bytes (each column costs about p(p+1) + 7p operations
// against 2p bytes of int16).  The design reads the gene once:
//   * The input form is a template parameter.  The engine's int16 upload
//     goes straight in (no float32 copy of the bucket is made); a value is
//     (float)raw, which is exact, and every operation after the load is the
//     same for both forms in the same order, so int16 input gives the bits
//     of float32 input holding the same values.  The launch geometry
//     depends on (p, W) alone, never on the input form.
//   * A block finds the gene's last active column from the mask, and the
//     columns up to there are split into `cl` contiguous shares, one a block
//     of the gene's cluster, so padding costs only its mask bytes.  A block
//     copies its share into shared memory with 16-byte loads (8 columns of
//     a row a load: one of int16, two of float32) issued without waiting for
//     the mask, masked-off columns as zeros (a zero column adds exactly
//     nothing, so the passes need no mask), and both passes (Gram and row
//     sums, then the clip) read the copy.  The copy takes at most the
//     launch's `stage_kb` (0: none), which sets the blocks an SM holds; the
//     columns past it are read from device memory in both passes, the second
//     time mostly from L2.
//   * Gram: the tile Gram of common.cuh (WarpGram<PMAX, true>) at every p,
//     so no instance spills and a thread needs few registers (the genes in
//     flight are what bounds the narrow buckets: each waits on a cold power
//     step of about 30 serial matvecs).  A column goes to the same lane at
//     the same step whether it was copied or not.
//   * The blocks' partials (Gram and row sums, then the clipped row sums) are
//     summed in a fixed order: warps, then the cluster's ranks through
//     distributed shared memory after one cluster barrier.  Warp 0 of every
//     block runs the power step on identical numbers.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

#define DN_RATIO_VEC 8          // columns of one 16-byte int16 load
#define DN_RATIO_MAX_WARPS 8    // 256 threads a block
#define DN_RATIO_MAX_CLUSTER 8  // the largest portable cluster

// Two int16 elements of a 32-bit word, each kept where its mask byte (of mw,
// from bit sh on) is not zero.
__device__ __forceinline__ uint32_t keep2(uint32_t v, uint32_t mw, int sh) {
  const uint32_t lo = ((mw >> sh) & 0xffu) ? 0x0000ffffu : 0u;
  const uint32_t hi = ((mw >> (sh + 8)) & 0xffu) ? 0xffff0000u : 0u;
  return v & (lo | hi);
}

// 8 elements of a row from device memory into the shared copy, zero where
// their mask byte is; src and dst 16-byte aligned.
__device__ __forceinline__ void stage8(const int16_t* src, int16_t* dst,
                                       uint2 m) {
  uint4 v = __ldg((const uint4*)src);
  v.x = keep2(v.x, m.x, 0);
  v.y = keep2(v.y, m.x, 16);
  v.z = keep2(v.z, m.y, 0);
  v.w = keep2(v.w, m.y, 16);
  *(uint4*)dst = v;
}

__device__ __forceinline__ void stage8(const float* src, float* dst, uint2 m) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float4 v = __ldg((const float4*)src + half);
    const uint32_t mw = half ? m.y : m.x;
    if (!(mw & 0xffu)) v.x = 0.f;
    if (!(mw & 0xff00u)) v.y = 0.f;
    if (!(mw & 0xff0000u)) v.z = 0.f;
    if (!(mw & 0xff000000u)) v.w = 0.f;
    ((float4*)dst)[half] = v;
  }
}

// One block's share of a gene: local column c is column c0 + c; columns below
// `cap` come from the block's shared copy (rows of `cap` elements), the rest
// from device memory with their mask byte.  Columns from `ext` on belong to
// the next block or lie past the gene's last active one.
template <int PMAX, class T>
struct RatioSrc {
  const T* stage;
  const T* __restrict__ F;  // the gene's (p, W) rows
  const uint8_t* __restrict__ mask;
  int p, W, c0, cap, ext;

  // x = A0's column c; false where the column adds nothing
  __device__ __forceinline__ bool col(int c, float (&x)[PMAX]) const {
    bool on = c < ext;
    if (on && c < cap) {
#pragma unroll
      for (int i = 0; i < PMAX; ++i)
        x[i] = i < p ? ratio_val(stage[i * cap + c]) : 0.f;
      return true;
    }
    const int w = c0 + c;
    on = on && mask[w] != 0;
#pragma unroll
    for (int i = 0; i < PMAX; ++i)
      x[i] = (on && i < p) ? ratio_val(F[(size_t)i * W + w]) : 0.f;
    return on;
  }
};

// Columns of a gene's first `ext` a block of `cl` takes: whole groups of 8.
__host__ __device__ inline int ratio_share(int ext, int cl) {
  const int per = (ext + cl - 1) / cl;
  return (per + DN_RATIO_VEC - 1) / DN_RATIO_VEC * DN_RATIO_VEC;
}

template <int PMAX>
struct RatioSmem {
  static constexpr int NG = PMAX * (PMAX + 1) / 2;
  static constexpr int NR = NG + PMAX;  // Gram, then row sums of A0
  float part[DN_RATIO_MAX_WARPS][NR];   // the warps' partials
  float tot1[NR];                       // this block's (read by the cluster)
  float tot2[PMAX];                     // this block's clipped row sums
  float sum[NR];                        // the gene's
  float u[PMAX], K[PMAX];
  float s;
  int last;  // the gene's last active group of 8 columns
};

// Floats of a warp's Gram tile (WarpGram<PMAX, true>, at every PMAX here: a
// tile a warp needs fewer registers than p(p+1)/2 partials a thread, and
// registers bound the genes in flight).
template <int PMAX>
__host__ __device__ constexpr int ratio_tile_floats() {
  return PMAX * DN_TILE_STRIDE;
}

template <int PMAX, bool I16>
__global__ void __launch_bounds__(32 * DN_RATIO_MAX_WARPS)
    ratio_rowsums_kernel(const void* __restrict__ Fv,
                         const uint8_t* __restrict__ mask,
                         float* __restrict__ cov_sums,
                         float* __restrict__ est_sums, int p, int W, int cl,
                         int cap, int vec, int power_cold) {
  using T = typename std::conditional<I16, int16_t, float>::type;
  constexpr int NG = RatioSmem<PMAX>::NG, NR = RatioSmem<PMAX>::NR;
  __shared__ RatioSmem<PMAX> sm;
  extern __shared__ float4 dyn4[];  // Gram tiles, then the copy
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cl > 1 ? (int)cluster.block_rank() : 0;
  const size_t g = blockIdx.x / cl;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31,
            warp = tid >> 5;
  float* tiles = (float*)dyn4;
  T* stage = (T*)(tiles + (nt >> 5) * ratio_tile_floats<PMAX>());
  const T* Fg = (const T*)Fv + g * p * W;
  const uint8_t* mg = mask + g * W;

  // the gene's last active group of 8 columns: every block of the cluster
  // scans the whole mask (the first read brings it into L2), so that the
  // shares are cut from the same number and each holds an equal part of
  // the active columns
  if (tid == 0) sm.last = -1;
  __syncthreads();
  {
    int last = -1;
    if (vec) {
#pragma unroll 8
      for (int j = tid; j < W / DN_RATIO_VEC; j += nt) {
        const uint2 m = __ldg((const uint2*)mg + j);
        if (m.x | m.y) last = j;
      }
    } else {
      for (int c = tid; c < W; c += nt)
        if (mg[c] != 0) last = c / DN_RATIO_VEC;
    }
    last = __reduce_max_sync(DN_FULL, last);
    if (lane == 0 && last >= 0) atomicMax(&sm.last, last);
  }
  __syncthreads();
  int ext = (sm.last + 1) * DN_RATIO_VEC;
  ext = ext < W ? ext : W;
  const int share = ratio_share(ext, cl);
  const int c0 = rank * share;
  ext -= c0;
  ext = ext < 0 ? 0 : ext < share ? ext : share;

  // the copy of the share, up to ext (vec: ext and cap are whole groups of 8
  // and every row starts 16-byte aligned).  The coverage and mask loads of
  // a group are independent (no load waits for a mask byte): below ext a
  // group is read whole, and zeroed where its mask is.
  const int sc = ext < cap ? ext : cap;
  if (vec) {
    const int ng = sc / DN_RATIO_VEC;
#pragma unroll 4
    for (int t = tid; t < p * ng; t += nt) {
      const int i = t / ng, c = (t - i * ng) * DN_RATIO_VEC;
      stage8(Fg + (size_t)i * W + c0 + c, stage + i * cap + c,
             __ldg((const uint2*)(mg + c0 + c)));
    }
  } else {
    for (int t = tid; t < p * sc; t += nt) {
      const int i = t / sc, c = t - i * sc;
      stage[i * cap + c] =
          mg[c0 + c] != 0 ? Fg[(size_t)i * W + c0 + c] : (T)0;
    }
  }
  __syncthreads();
  RatioSrc<PMAX, T> src{stage, Fg, mg, p, W, c0, cap, ext};

  // pass 1: Gram of A0 and its row sums
  {
    WarpGram<PMAX, true> gram;
    gram.init(tiles + warp * ratio_tile_floats<PMAX>());
    gram.zero();
    float rs[PMAX];
#pragma unroll
    for (int i = 0; i < PMAX; ++i) rs[i] = 0.f;
    for (int l0 = warp * 32; l0 < ext; l0 += nt) {
      float x[PMAX];
      const bool on = src.col(l0 + lane, x);
#pragma unroll
      for (int i = 0; i < PMAX; ++i) rs[i] += x[i];
      gram.add(x, on, lane);
    }
    gram.flush(sm.part[warp], lane);
    warp_reduce_store<PMAX>(rs, sm.part[warp] + NG, lane);
  }
  __syncthreads();
  for (int k = tid; k < NR; k += nt) {
    float t = 0.f;
    for (int w = 0; w < (nt >> 5); ++w) t += sm.part[w][k];
    sm.tot1[k] = t;
  }
  if (cl > 1) {
    cluster.sync();
    for (int k = tid; k < NR; k += nt) {
      float t = 0.f;
      for (int r = 0; r < cl; ++r)
        t += cluster.map_shared_rank(&sm.tot1[0], r)[k];
      sm.sum[k] = t;
    }
  } else {
    __syncthreads();
    for (int k = tid; k < NR; k += nt) sm.sum[k] = sm.tot1[k];
  }
  __syncthreads();
  if (warp == 0) {
    float row[PMAX];
    load_gram_row<PMAX>(sm.sum, lane, row);
    float s = 0.f;
    float u = lane < p ? 1.0f / sqrtf((float)p) : 0.f;
    u = power_refit<PMAX>(row, u, power_cold, 0, true, s);
    if (lane < PMAX) {
      sm.u[lane] = u;
      sm.K[lane] = u * s;
    }
    if (lane == 0) sm.s = s;
    if (rank == 0 && lane < p) cov_sums[g * p + lane] = sm.sum[NG + lane];
  }
  __syncthreads();

  // pass 2: row sums of max(K E, A0)
  {
    const float den = sm.s + DN_EPS;
    float es[PMAX];
#pragma unroll
    for (int i = 0; i < PMAX; ++i) es[i] = 0.f;
    for (int l0 = warp * 32; l0 < ext; l0 += nt) {
      float x[PMAX];
      if (!src.col(l0 + lane, x)) continue;
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < PMAX; ++i)
        v = fmaf(x[i], sm.u[i], v);
      const float e = v / den;
#pragma unroll
      for (int i = 0; i < PMAX; ++i)
        es[i] += fmaxf(sm.K[i] * e, x[i]);
    }
    warp_reduce_store<PMAX>(es, sm.part[warp], lane);
  }
  __syncthreads();
  if (tid < PMAX) {
    float t = 0.f;
    for (int w = 0; w < (nt >> 5); ++w) t += sm.part[w][tid];
    sm.tot2[tid] = t;
  }
  if (cl > 1) {
    cluster.sync();
    if (rank == 0 && tid < p) {
      float t = 0.f;
      for (int r = 0; r < cl; ++r)
        t += cluster.map_shared_rank(&sm.tot2[0], r)[tid];
      est_sums[g * p + tid] = t;
    }
    // no block may leave while rank 0 can still read its partial
    cluster.sync();
  } else {
    __syncthreads();
    if (tid < p) est_sums[g * p + tid] = sm.tot2[tid];
  }
}


template <int PM, bool I16>
static int launch_ratio(const void* F, const uint8_t* mask, float* cov,
                        float* est, int G, int p, int W, int power_cold,
                        int cl, int threads, int stage_kb,
                        cudaStream_t st) {
  auto kern = ratio_rowsums_kernel<PM, I16>;
  const size_t elem = I16 ? sizeof(int16_t) : sizeof(float);
  int dev = 0, smem_blk = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_blk,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return (int)e;
  // the copy takes at most stage_kb KB (the blocks an SM can hold follow
  // from it) and a share at most; the rest of a share is read from device
  // memory twice
  const size_t tiles =
      sizeof(float) * (threads / 32) * ratio_tile_floats<PM>();
  long long room = (long long)smem_blk - (long long)fa.sharedSizeBytes -
                   (long long)tiles;
  if (room > 1024LL * stage_kb) room = 1024LL * stage_kb;
  long long cap = room > 0 ? room / (long long)(p * elem) : 0;
  cap = cap / DN_RATIO_VEC * DN_RATIO_VEC;
  const long long share = ratio_share(W, cl);
  if (cap > share) cap = share;
  const size_t dyn = tiles + (size_t)cap * p * elem;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)dyn);
  if (e != cudaSuccess) return (int)e;
  // 16-byte loads: rows whole groups of 8 columns, aligned bases
  const int vec = W % DN_RATIO_VEC == 0 && ((uintptr_t)F & 15) == 0 &&
                  ((uintptr_t)mask & 7) == 0;
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
  return (int)cudaLaunchKernelEx(&cfg, kern, F, mask, cov, est, p, W, cl,
                                 (int)cap, vec, power_cold);
}

// The arguments of a launch, handed from the C entry point (ratio.cu) to the
// translation unit of the input form (ratio_f32.cu, ratio_i16.cu).
struct RatioArgs {
  const void* F;  // int16 or float32
  const uint8_t* mask;
  float* cov;
  float* est;
  int G, p, W, power_cold, cl, threads, stage_kb;
  cudaStream_t st;
  float* ws = nullptr;  // p > 32: the wide and panel instances' workspace
                        // (ratio.cu)
  int ws_slots = 0;
};

template <bool I16>
static int launch_ratio_form(const RatioArgs& a) {
#define DN_RATIO_ARGS                                                      \
  a.F, a.mask, a.cov, a.est, a.G, a.p, a.W, a.power_cold, a.cl, a.threads, \
      a.stage_kb, a.st
  if (a.p <= 4) return launch_ratio<4, I16>(DN_RATIO_ARGS);
  if (a.p <= 8) return launch_ratio<8, I16>(DN_RATIO_ARGS);
  if (a.p <= 16) return launch_ratio<16, I16>(DN_RATIO_ARGS);
  return launch_ratio<32, I16>(DN_RATIO_ARGS);
#undef DN_RATIO_ARGS
}

int dn_ratio_f32(const RatioArgs& a);
int dn_ratio_i16(const RatioArgs& a);
// the instances for 33 <= p <= 128 (ratio_wide.cuh: ratio_wide_f32.cu,
// ratio_wide_i16.cu): phases over the card, a gene's columns in chunks
int dn_ratio_wide_f32(const RatioArgs& a);
int dn_ratio_wide_i16(const RatioArgs& a);
// the instances for p > 128 (ratio_panel.cu: panel.cuh's core), both forms
int dn_ratio_panel(const RatioArgs& a, int f_is_i16);
// p > DN_PCL_MAX_P_STREAM: the phased layout (ratio_phase.cu)
int dn_ratio_phase(const RatioArgs& a, int f_is_i16);
