// Kernel 1 (nmf.cuh), the instances of its nmf_tol branch (ADAPT): one
// translation unit, so that they compile beside the default ones.
#include "nmf.cuh"

int dn_nmf_block_tol(const NmfArgs& a) { return launch_block<true>(a); }

int dn_nmf_warp_tol(const NmfArgs& a) { return launch_warp_any<true>(a); }
