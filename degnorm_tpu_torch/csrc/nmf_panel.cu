// Kernel 1 for p > 128 samples: the Lagrangian NMF-OA loop, one thread
// block of DN_WIDE_THREADS a gene at a time, on panel.cuh's row-panel core;
// both branches (ADAPT: nmf_tol) in this one translation unit.  The C entry
// point stays nmf.cu's dn_nmf_masked, which hands p > 128 here.
//
// Replaces, for studies of more than 128 samples, the TPU kernel
// degnorm_tpu/ops/pallas_nmf.py::nmf_masked_pallas (_nmf_kernel /
// _nmf_loop), as nmf_wide.cuh does for 33 <= p <= 128, with the same
// arguments and results.  Bound on this card: float32 operations (the
// Gram's p(p+1) a column a sweep), see panel.cuh.  X in the global scratch;
// a block works through the genes blockIdx.x, + gridDim.x, ... with its own
// slot of the workspace.  An inactive gene gets zeros.
#include "nmf.cuh"
#include "panel.cuh"

template <bool ADAPT>
__global__ void __launch_bounds__(DN_WIDE_THREADS, 1)
    nmf_panel_kernel(const float* __restrict__ F,
                     const uint8_t* __restrict__ mask,
                     const uint8_t* __restrict__ act,
                     const float* __restrict__ u0, float* Xscratch,
                     float* __restrict__ K, float* __restrict__ E,
                     float* __restrict__ u, int* __restrict__ iters, int G,
                     int p, int W, int nmf_iter, int power_cold,
                     int power_warm, int warm_plain, float tol, float* ws) {
  extern __shared__ float4 dyn4[];
  const int tid = threadIdx.x, nt = blockDim.x;
  PanelWork w;
  w.init((float*)dyn4, ws + blockIdx.x * dn_panel_ws_floats(p), p);
  for (size_t g = blockIdx.x; g < (size_t)G; g += gridDim.x) {
    float* Eg = E + g * W;
    if (act != nullptr && act[g] == 0) {
      for (int i = tid; i < p; i += nt) {
        K[g * p + i] = 0.f;
        u[g * p + i] = 0.f;
      }
      for (int l = tid; l < W; l += nt) Eg[l] = 0.f;
      if (tid == 0 && iters != nullptr) iters[g] = 0;
      continue;
    }
    for (int i = tid; i < w.np; i += nt)
      w.u[i] = i < p ? (u0 != nullptr ? u0[g * p + i]
                                      : 1.0f / sqrtf((float)p))
                     : 0.f;
    __syncthreads();
    const WideResidentSrc src{F + g * p * W, mask + g * W,
                              Xscratch + g * p * W, Eg, W};
    float s;
    int ran;
    panel_core<ADAPT>(src, w, s, nmf_iter, power_cold, power_warm,
                      warm_plain, tol, &ran);
    for (int i = tid; i < p; i += nt) {
      K[g * p + i] = w.u[i] * s;
      u[g * p + i] = w.u[i];
    }
    if (tid == 0 && iters != nullptr) iters[g] = ran;
    __syncthreads();  // u is read before the next gene writes it
  }
}

int dn_nmf_panel(const NmfArgs& a) {
  if (a.threads != DN_WIDE_THREADS || a.p < DN_PANEL_MIN_P || a.ws == nullptr)
    return (int)cudaErrorInvalidValue;
#define DN_NMF_PANEL_ARGS                                                     \
  a.G, a.ws_slots, 0, a.stream, a.F, a.mask, a.act, a.u0, a.X, a.K, a.E, a.u, \
      a.iters, a.G, a.p, a.W, a.nmf_iter, a.power_cold, a.power_warm,         \
      a.warm_plain, a.tol, a.ws
  if (a.tol > 0.f)
    return launch_panel(nmf_panel_kernel<true>, DN_NMF_PANEL_ARGS);
  return launch_panel(nmf_panel_kernel<false>, DN_NMF_PANEL_ARGS);
#undef DN_NMF_PANEL_ARGS
}
