// Kernel 3 (trim.cuh), the instances of its trim_fast branch: one
// translation unit, so that they compile beside the default ones.
#include "trim.cuh"

int dn_trim_fast(const TrimArgs& a) { return launch_trim<DN_TRIM_FAST>(a); }
