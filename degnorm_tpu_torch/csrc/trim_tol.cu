// Kernel 3 (trim.cuh), the instances of its nmf_tol branch: one translation
// unit, so that they compile beside the default ones.
#include "trim.cuh"

int dn_trim_tol(const TrimArgs& a) { return launch_trim<DN_TRIM_TOL>(a); }
