// Kernel 4c's wide instances (stream_cols_wide.cuh) for raw int16 + scale
// input: one translation unit an input form, so that they compile side by
// side.
#include "stream_cols_wide.cuh"

int dn_wcols_i16(int which, const ColsArgs& a) {
  return wcols_launch_form<true, false>(which, a);
}
