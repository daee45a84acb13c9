// Kernel 3 for 33 <= p <= 128 (trim_wide.cuh), the instances of its nmf_tol
// branch: one translation unit, so that they compile beside the others.
#include "trim_wide.cuh"

int dn_trim_wide_tol(const TrimArgs& a) {
  return launch_trim_wide<DN_TRIM_TOL>(a);
}
