// Kernel 1 for 33 <= p <= 128 (nmf_wide.cuh), its default instances: one
// translation unit, so that they compile beside the others.
#include "nmf_wide.cuh"

int dn_nmf_wide(const NmfArgs& a) { return launch_nmf_wide<false>(a); }

// The resident core's geometry at (p, W) (wide_res.cuh), for the check of
// its mirror ops/cuda_nmf.py::res_geometry: out = the most slots a block
// holds, the launches (cluster sizes 1 ..), then each launch's shared
// memory a block (dynamic and the static bound; 0 past the last), for
// DN_RES_MAX_CLUSTER launches.  Returns 0, or 1 outside 33 <= p <= 128.
extern "C" int dn_res_geometry(int p, int W, int* out) {
  if (p < DN_WIDE_MIN_P || p > DN_WIDE_MAX_P) return 1;
#define CALL(PM)                                                          \
  do {                                                                    \
    const int capmax = dn_res_capmax(PM, W);                              \
    const int ncl = capmax ? dn_res_gene_cluster(W, capmax) : 0;          \
    out[0] = capmax;                                                      \
    out[1] = ncl;                                                         \
    for (int cl = 1; cl <= DN_RES_MAX_CLUSTER; ++cl)                      \
      out[1 + cl] = cl <= ncl ? dn_res_dyn_bytes(PM, W, dn_res_cap(       \
                                    W, cl, capmax)) +                     \
                                    dn_res_static_bytes(PM)               \
                              : 0;                                        \
  } while (0)
  DN_DISPATCH_WIDE_P(p, CALL);
#undef CALL
  return 0;
}
