// Kernel 1 for 33 <= p <= 128 samples: the Lagrangian NMF-OA loop, one
// thread block of DN_WIDE_THREADS a gene, on wide.cuh's block-level SYRK
// layout.  The C entry point stays nmf.cu's dn_nmf_masked, which hands p > 32
// here; the default instances are compiled in nmf_wide.cu and the nmf_tol
// ones (ADAPT) in nmf_wide_tol.cu, side by side.
//
// Replaces, for wide studies, the TPU kernel degnorm_tpu/ops/pallas_nmf.py::
// nmf_masked_pallas (_nmf_kernel / _nmf_loop), as nmf.cuh does for p <= 32,
// with the same arguments and results.  Only the block-a-gene launch: a warp
// a gene (nmf.cuh) stops at p = 16.  Bound on this card: float32 operations
// (the Gram's p(p+1) a column a sweep), see wide.cuh.  X in the global
// scratch, as the block launch of nmf.cuh keeps it.  An inactive gene
// returns zeros at once.
//
// At the PMAX where dn_res_on holds, kernel 1 runs on wide_res.cuh's
// resident core instead (nmf_res_kernel): the gene's X in the shared memory
// of a block or a cluster of blocks for the whole loop, the Gram on the
// tensor cores by 3xTF32; the X scratch is not touched.
#pragma once
#include "nmf.cuh"
#include "wide_res.cuh"

template <int PMAX, bool ADAPT>
__global__ void __launch_bounds__(DN_WIDE_THREADS, dn_wide_min_blocks<PMAX>())
    nmf_wide_kernel(const float* __restrict__ F,
                    const uint8_t* __restrict__ mask,
                    const uint8_t* __restrict__ act,
                    const float* __restrict__ u0, float* Xscratch,
                    float* __restrict__ K, float* __restrict__ E,
                    float* __restrict__ u, int* __restrict__ iters, int p,
                    int W, int nmf_iter, int power_cold, int power_warm,
                    int warm_plain, float tol) {
  extern __shared__ float4 dyn4[];
  const size_t g = blockIdx.x;
  const int tid = threadIdx.x;
  float* Eg = E + g * W;
  if (act != nullptr && act[g] == 0) {
    if (tid < p) {
      K[g * p + tid] = 0.f;
      u[g * p + tid] = 0.f;
    }
    for (int w = tid; w < W; w += blockDim.x) Eg[w] = 0.f;
    if (tid == 0 && iters != nullptr) iters[g] = 0;
    return;
  }
  WideWork<PMAX> w;
  w.init((float*)dyn4);
  if (tid < PMAX)
    w.u[tid] = tid < p ? (u0 != nullptr ? u0[g * p + tid]
                                        : 1.0f / sqrtf((float)p))
                       : 0.f;
  __syncthreads();
  const WideResidentSrc src{F + g * p * W, mask + g * W, Xscratch + g * p * W,
                            Eg, W};
  float s;
  int ran;
  wide_core<PMAX, ADAPT>(src, WideBlockRed{}, w, p, s, nmf_iter, power_cold,
                         power_warm, warm_plain, tol, &ran);
  if (tid < p) {
    K[g * p + tid] = w.u[tid] * s;
    u[g * p + tid] = w.u[tid];
  }
  if (tid == 0 && iters != nullptr) iters[g] = ran;
}

// Kernel 1 on the resident core: a cluster of cl blocks a gene, each its
// share of the gene's active columns (wide_res.cuh); this launch runs the
// genes whose clusters are of cl blocks (cap slots a block, capmax the most
// any launch's blocks hold), the one of clusters of 1 the inactive genes.
template <int PMAX, bool ADAPT>
__global__ void __launch_bounds__(DN_WIDE_THREADS, 1)
    nmf_res_kernel(const float* __restrict__ F,
                   const uint8_t* __restrict__ mask,
                   const uint8_t* __restrict__ act,
                   const float* __restrict__ u0, float* __restrict__ K,
                   float* __restrict__ E, float* __restrict__ u,
                   int* __restrict__ iters, int p, int W, int nmf_iter,
                   int power_cold, int power_warm, int warm_plain, float tol,
                   int cap, int capmax, int cl) {
  extern __shared__ float4 dyn4[];
  const int rank = cl > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const size_t g = blockIdx.x / cl;
  const int tid = threadIdx.x;
  const uint8_t* mg = mask + g * W;
  float* Eg = E + g * W;
  // act[g] is the same for the whole cluster: all its blocks leave here
  if (act != nullptr && act[g] == 0) {
    if (cl > 1) return;
    if (tid < p) {
      K[g * p + tid] = 0.f;
      u[g * p + tid] = 0.f;
    }
    for (int w = tid; w < W; w += DN_WIDE_THREADS) Eg[w] = 0.f;
    if (tid == 0 && iters != nullptr) iters[g] = 0;
    return;
  }
  ResWork<PMAX> r;
  r.init((float*)dyn4, W, cap, cl, rank);
  const auto on_col = [&](int w) { return mg[w] != 0; };
  if (!res_gene_runs(W, capmax, cl, on_col, (int*)r.ww.red)) return;
  if (tid < PMAX)
    r.ww.u[tid] = tid < p ? (u0 != nullptr ? u0[g * p + tid]
                                           : 1.0f / sqrtf((float)p))
                          : 0.f;
  const float* Fg = F + g * p * W;
  res_deal<PMAX>(r, p, W, on_col, nullptr);
  float s;
  int ran;
  res_core<PMAX, ADAPT>(r, Fg, Eg, p, W, [](int) { return true; }, s,
                        nmf_iter, power_cold, power_warm, warm_plain, tol,
                        &ran);
  // this block's share of E outside the active columns
  const int w_lo = (int)((long long)W * rank / cl);
  const int w_hi = (int)((long long)W * (rank + 1) / cl);
  for (int w = w_lo + tid; w < w_hi; w += DN_WIDE_THREADS)
    if (mg[w] == 0) Eg[w] = 0.f;
  if (rank == 0) {
    if (tid < p) {
      K[g * p + tid] = r.ww.u[tid] * s;
      u[g * p + tid] = r.ww.u[tid];
    }
    if (tid == 0 && iters != nullptr) iters[g] = ran;
  }
}

template <bool ADAPT>
int launch_nmf_wide(const NmfArgs& a) {
  if (a.threads != DN_WIDE_THREADS || a.p < DN_WIDE_MIN_P ||
      a.p > DN_WIDE_MAX_P)
    return (int)cudaErrorInvalidValue;
  if (a.G == 0) return 0;
#define CALL(PM)                                                            \
  do {                                                                      \
    if constexpr (dn_res_on<PM>()) {                                        \
      const int e = dn_res_launch<PM>(                                      \
          nmf_res_kernel<PM, ADAPT>, a.G, a.W, a.stream, a.F, a.mask,       \
          a.act, a.u0, a.K, a.E, a.u, a.iters, a.p, a.W, a.nmf_iter,        \
          a.power_cold, a.power_warm, a.warm_plain, a.tol);                 \
      if (e != 0) return e;                                                 \
    } else {                                                                \
      const size_t dyn = sizeof(float) * wide_sync_floats<PM>();            \
      cudaError_t e = cudaFuncSetAttribute(                                 \
          nmf_wide_kernel<PM, ADAPT>,                                       \
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);           \
      if (e != cudaSuccess) return (int)e;                                  \
      nmf_wide_kernel<PM, ADAPT><<<a.G, DN_WIDE_THREADS, dyn, a.stream>>>(  \
          a.F, a.mask, a.act, a.u0, a.X, a.K, a.E, a.u, a.iters, a.p, a.W,  \
          a.nmf_iter, a.power_cold, a.power_warm, a.warm_plain, a.tol);     \
    }                                                                       \
  } while (0)
  DN_DISPATCH_WIDE_P(a.p, CALL);
#undef CALL
  return (int)cudaGetLastError();
}
