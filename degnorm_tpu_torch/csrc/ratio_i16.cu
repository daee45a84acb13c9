// Kernel 2 (ratio.cuh), the instances for the raw int16 upload: one
// translation unit an input form, so that they compile side by side.
#include "ratio.cuh"

int dn_ratio_i16(const RatioArgs& a) { return launch_ratio_form<true>(a); }
