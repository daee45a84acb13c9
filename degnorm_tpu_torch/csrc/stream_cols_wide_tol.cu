// Kernel 4c's wide instances (stream_cols_wide.cuh), its ADAPT instances
// (EngineConfig.nmf_tol > 0) for both input forms and the finishing
// launch: a translation unit of their own, so that they compile beside the
// default ones.
#include "stream_cols_wide.cuh"

int dn_wcols_tol(int f_is_i16, int which, const ColsArgs& a) {
  return f_is_i16 ? wcols_launch_form<true, true>(which, a)
                  : wcols_launch_form<false, true>(which, a);
}
