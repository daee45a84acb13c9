// Kernel 3's C entry point and its default instances; the kernel itself is
// trim.cuh, its trim_fast and nmf_tol instances are compiled in trim_fast.cu
// and trim_tol.cu.
#include "trim.cuh"

// X: (G, p, W) float32 scratch; fast != 0 runs the trim_fast branch, else
// tol > 0 the nmf_tol one; iters: (G) int32 or null.  p > 32 takes the wide
// instances (trim_wide.cuh), whose block is DN_WIDE_THREADS threads, and
// p > 128 the panel instance (trim_panel.cu), which also takes ws: on its
// cluster layout ws_slots workspaces of dn_pcl_ws_floats(p) floats where a
// block holds several pairs, past it dn_phase_ws_floats(p, ws_slots, G) +
// dn_trim_phase_floats(p, W, B, G) floats (null and 0 below); past the
// cluster layout E is only read (elsewhere each round writes it).
extern "C" int dn_trim_loop(
    const float* Fm, const int* bin_id, const float* bin_count,
    const float* K0, float* E, const float* rho0, const float* u0,
    const int* n_hi, const int* n_bins, const uint8_t* active0, float* X,
    uint8_t* colmask, float* K, float* rho, uint8_t* ran_bs,
    int* rounds_active, int* iters, int G, int p, int W, int B, int nmf_iter,
    int power_resume, int power_warm, int warm_plain, int max_rounds,
    int min_bins, int min_gene_len, int fast, float tol, int threads,
    float* ws, int ws_slots, void* stream) {
  TrimArgs a = {Fm,         bin_id,       bin_count,  K0,
                E,          rho0,         u0,         n_hi,
                n_bins,     active0,      X,          colmask,
                K,          rho,          ran_bs,     rounds_active,
                iters,      G,            p,          W,
                B,          nmf_iter,     power_resume, power_warm,
                warm_plain, max_rounds,   min_bins,   min_gene_len,
                tol,        threads,      (cudaStream_t)stream};
  a.ws = ws;
  a.ws_slots = ws_slots;
  if (p > 128)
    return dn_trim_panel(a, fast ? DN_TRIM_FAST
                            : tol > 0.f ? DN_TRIM_TOL : DN_TRIM_DEFAULT);
  if (p > 32) {
    if (fast) return dn_trim_wide_fast(a);
    if (tol > 0.f) return dn_trim_wide_tol(a);
    return dn_trim_wide(a);
  }
  if (fast) return dn_trim_fast(a);
  if (tol > 0.f) return dn_trim_tol(a);
  return launch_trim<DN_TRIM_DEFAULT>(a);
}
