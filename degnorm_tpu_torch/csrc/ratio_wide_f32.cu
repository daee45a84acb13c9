// Kernel 2 for 33 <= p <= 128 (ratio_wide.cuh), the instances for
// float32 input: one translation unit an input form, so that they compile
// side by side.
#include "ratio_wide.cuh"

int dn_ratio_wide_f32(const RatioArgs& a) {
  return launch_ratio_wide<false>(a);
}
