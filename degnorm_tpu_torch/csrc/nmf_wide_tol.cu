// Kernel 1 for 33 <= p <= 128 (nmf_wide.cuh), the instances of its nmf_tol
// branch (ADAPT): one translation unit, so that they compile beside the
// default ones.
#include "nmf_wide.cuh"

int dn_nmf_wide_tol(const NmfArgs& a) { return launch_nmf_wide<true>(a); }
