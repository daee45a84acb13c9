// Kernel 1 for p > 128 samples: the Lagrangian NMF-OA loop, on panel.cuh's
// row panels; both branches (ADAPT: nmf_tol) in this one translation unit.
// The C entry point stays nmf.cu's dn_nmf_masked, which hands p > 128 here.
//
// Replaces, for studies of more than 128 samples, the TPU kernel
// degnorm_tpu/ops/pallas_nmf.py::nmf_masked_pallas (_nmf_kernel /
// _nmf_loop), as nmf_wide.cuh does for 33 <= p <= 128, with the same
// arguments and results.  Bound on this card: float32 operations (the
// Gram's p(p+1) a column a sweep), see panel.cuh.  Two layouts: p <=
// DN_PCL_MAX_P a cluster of blocks a gene, its panel pairs over the blocks
// (nmf_panel_kernel, pcl_core, X column by column in the scratch); above,
// phase.cuh's phased layout, kernel 4's loop (stream_phase.cu's
// phase_loop) on float32 input with the nmf_tol branch, X row by row in the
// scratch and ws a workspace of dn_phase_ws_floats(p, ws_slots, G) floats
// (kernel 3's rounds run the same loop: trim_panel.cu).  An inactive gene
// gets zeros.
#include "phase.cuh"
#include "nmf.cuh"

template <bool ADAPT>
__global__ void __launch_bounds__(DN_WIDE_THREADS, 1)
    nmf_panel_kernel(const float* __restrict__ F,
                     const uint8_t* __restrict__ mask,
                     const uint8_t* __restrict__ act,
                     const float* __restrict__ u0, float* Xscratch,
                     float* __restrict__ K, float* __restrict__ E,
                     float* __restrict__ u, int* __restrict__ iters, int G,
                     int p, int W, int nmf_iter, int power_cold,
                     int power_warm, int warm_plain, float tol,
                     float* ws) {
  extern __shared__ float4 dyn4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  PclWork<float> w;
  // (the cluster's slot of the workspace where a block holds several pairs)
  w.init((float*)dyn4, p, rank,
         ws != nullptr ? ws + (blockIdx.x / C) * dn_pcl_ws_floats(p)
                       : nullptr);
  for (size_t g = blockIdx.x / C; g < (size_t)G; g += gridDim.x / C) {
    float* Eg = E + g * W;
    // act[g] is the same for the whole cluster: every block skips the gene
    if (act != nullptr && act[g] == 0) {
      if (rank == 0) {
        for (int i = tid; i < p; i += nt) {
          K[g * p + i] = 0.f;
          u[g * p + i] = 0.f;
        }
        for (int l = tid; l < W; l += nt) Eg[l] = 0.f;
        if (tid == 0 && iters != nullptr) iters[g] = 0;
      }
      continue;
    }
    for (int i = tid; i < w.np; i += nt)
      w.u()[i] = i < p ? (u0 != nullptr ? u0[g * p + i]
                                      : 1.0f / sqrtf((float)p))
                     : 0.f;
    __syncthreads();
    w.X = Xscratch + g * W * w.ldx;  // X column by column
    const WideResidentSrc src{F + g * p * W, mask + g * W, nullptr, Eg, W};
    float s;
    int ran;
    pcl_core<ADAPT>(src, w, s, nmf_iter, power_cold, power_warm, warm_plain,
                    tol, &ran);
    if (rank == 0) {
      for (int i = tid; i < p; i += nt) {
        K[g * p + i] = w.u()[i] * s;
        u[g * p + i] = w.u()[i];
      }
      if (tid == 0 && iters != nullptr) iters[g] = ran;
    }
    __syncthreads();  // u is read before the next gene writes it
  }
}

int dn_nmf_panel(const NmfArgs& a) {
  if (a.threads != DN_WIDE_THREADS || a.p < DN_PANEL_MIN_P)
    return (int)cudaErrorInvalidValue;
  if (dn_pcl_on(a.p, DN_PCL_LOOP)) {
    // blocks of several pairs keep them in the workspace
    if (dn_pcl_held(a.p) > 1 && a.ws == nullptr)
      return (int)cudaErrorInvalidValue;
#define DN_NMF_PCL_ARGS                                                       \
  DN_PCL_LOOP,                                                                \
  a.G, a.p, a.ws_slots, (size_t)dn_pcl_smem_floats(a.p), a.stream, a.F,       \
      a.mask, a.act, a.u0, a.X, a.K, a.E, a.u, a.iters, a.G, a.p, a.W,        \
      a.nmf_iter, a.power_cold, a.power_warm, a.warm_plain, a.tol,            \
      dn_pcl_held(a.p) > 1 ? a.ws : nullptr
    if (a.tol > 0.f) return launch_pcl(nmf_panel_kernel<true>, DN_NMF_PCL_ARGS);
    return launch_pcl(nmf_panel_kernel<false>, DN_NMF_PCL_ARGS);
#undef DN_NMF_PCL_ARGS
  }
  if (!dn_phase_on(a.p, DN_PCL_LOOP) || !phase_fits(a.p) || a.ws == nullptr ||
      a.ws_slots < 1)
    return (int)cudaErrorInvalidValue;
  if (a.G == 0) return 0;
  PhaseArgs pa = {};
  pa.F = a.F;
  pa.mask = a.mask;
  pa.X = a.X;
  pa.u0 = a.u0;
  pa.K = a.K;
  pa.E = a.E;
  pa.u = a.u;
  pa.iters = a.iters;
  pa.G = a.G;
  pa.p = a.p;
  pa.W = a.W;
  pa.nmf_iter = a.nmf_iter;
  pa.tol = a.tol > 0.f ? a.tol : 0.f;
  phase_parts(pa, a.ws, a.ws_slots, false);
  return phase_loop(pa, false, a.act, nullptr, a.ws_slots, a.power_cold,
                    a.power_warm, a.warm_plain, a.stream);
}
