// Kernel 1's C entry points and its default instances; the kernel itself is
// nmf.cuh, its nmf_tol instances are compiled in nmf_tol.cu.
#include "nmf.cuh"

// X: (G, p, W) float32 scratch; tol > 0 runs the nmf_tol branch; iters:
// (G) int32 or null.  p > 32 takes the wide instances (nmf_wide.cuh), whose
// block is DN_WIDE_THREADS threads, and p > 128 the panel instance
// (nmf_panel.cu), which also takes ws: on its cluster layout ws_slots
// workspaces of dn_pcl_ws_floats(p) floats where a block holds several
// pairs, past it (the phased layout) dn_phase_ws_floats(p, ws_slots, G)
// floats, ws_slots genes in flight (null and 0 below).
extern "C" int dn_nmf_masked(const float* F, const uint8_t* mask,
                             const uint8_t* act, const float* u0, float* X,
                             float* K, float* E, float* u, int G, int p, int W,
                             int nmf_iter, int power_cold, int power_warm,
                             int warm_plain, float tol, int* iters,
                             int threads, float* ws, int ws_slots,
                             void* stream) {
  NmfArgs a = {F,          mask,       act,     u0,      nullptr,
               X,          K,          E,       u,       iters,
               G,          p,          W,       nmf_iter, power_cold,
               power_warm, warm_plain, tol,     threads,
               (cudaStream_t)stream};
  a.ws = ws;
  a.ws_slots = ws_slots;
  if (p > 128) return dn_nmf_panel(a);
  if (p > 32) return tol > 0.f ? dn_nmf_wide_tol(a) : dn_nmf_wide(a);
  return tol > 0.f ? dn_nmf_block_tol(a) : launch_block<false>(a);
}

// X: (G, p, W) float32 scratch; next: one int32, zero at the launch.
extern "C" int dn_nmf_masked_warp(const float* F, const uint8_t* mask,
                                  const uint8_t* act, const float* u0,
                                  int* next, float* X, float* K, float* E,
                                  float* u, int G, int p, int W, int nmf_iter,
                                  int power_cold, int power_warm,
                                  int warm_plain, float tol, int* iters,
                                  int threads, void* stream) {
  const NmfArgs a = {F,          mask,       act,     u0,      next,
                     X,          K,          E,       u,       iters,
                     G,          p,          W,       nmf_iter, power_cold,
                     power_warm, warm_plain, tol,     threads,
                     (cudaStream_t)stream};
  return tol > 0.f ? dn_nmf_warp_tol(a) : launch_warp_any<false>(a);
}
