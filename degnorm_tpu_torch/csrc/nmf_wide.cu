// Kernel 1 for 33 <= p <= 128 (nmf_wide.cuh), its default instances: one
// translation unit, so that they compile beside the others.
#include "nmf_wide.cuh"

int dn_nmf_wide(const NmfArgs& a) { return launch_nmf_wide<false>(a); }
