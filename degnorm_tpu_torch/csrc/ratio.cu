// Kernel 2's C entry point; the kernel itself is ratio.cuh, its template
// instances are compiled in ratio_<f32|i16>.cu.
#include "ratio.cuh"

// F: (G, p, W) int16 (f_is_i16) or float32.  cl: blocks a gene, 1, 2, 4 or
// 8.  threads: a multiple of 32, at most 256.  stage_kb: the most shared
// memory a block copies its share of a gene into (0: read it from device
// memory twice).  p > 32 takes the wide instances (ratio_wide.cuh): cl 1 and
// DN_WIDE_THREADS threads, and ws: ws_slots slots of dn_rw_slot_floats(PMAX,
// W) floats, the genes of a group; p > 128 the panel instance
// (ratio_panel.cu), whose ws is on its cluster layout (p <=
// DN_PCL_MAX_P_STREAM) ws_slots workspaces of dn_pcl_ws_floats(p) floats, one
// a cluster in flight, where a block holds several pairs (else null), above
// it (ratio_phase.cu) a workspace of dn_phase_ws_floats(p, ws_slots, G)
// floats, ws_slots genes in flight.
extern "C" int dn_ratio_rowsums(const void* F, int f_is_i16,
                                const uint8_t* mask, float* cov_sums,
                                float* est_sums, int G, int p, int W,
                                int power_cold, int cl, int threads,
                                int stage_kb, float* ws, int ws_slots,
                                void* stream) {
  if (p > 32) {  // the wide instances: cl 1, DN_WIDE_THREADS threads
    RatioArgs a = {F,        mask, cov_sums,   est_sums, G,
                   p,        W,    power_cold, cl,       threads,
                   stage_kb, (cudaStream_t)stream};
    a.ws = ws;
    a.ws_slots = ws_slots;
    const int code = p > 128        ? dn_ratio_panel(a, f_is_i16)
                     : f_is_i16     ? dn_ratio_wide_i16(a)
                                    : dn_ratio_wide_f32(a);
    if (code != 0) return code;
    return (int)cudaGetLastError();
  }
  if (threads % 32 != 0 || threads < 32 || threads > 32 * DN_RATIO_MAX_WARPS ||
      cl < 1 || cl > DN_RATIO_MAX_CLUSTER || (cl & (cl - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (G == 0) return 0;
  const RatioArgs a = {F,        mask, cov_sums,   est_sums, G,
                       p,        W,    power_cold, cl,       threads,
                       stage_kb, (cudaStream_t)stream};
  const int code = f_is_i16 ? dn_ratio_i16(a) : dn_ratio_f32(a);
  if (code != 0) return code;
  return (int)cudaGetLastError();
}
