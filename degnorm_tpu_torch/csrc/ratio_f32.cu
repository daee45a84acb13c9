// Kernel 2 (ratio.cuh), the instances for float32 input: one translation unit
// an input form, so that they compile side by side.
#include "ratio.cuh"

int dn_ratio_f32(const RatioArgs& a) { return launch_ratio_form<false>(a); }
