// Kernel 4c's wide instances (stream_cols_wide.cuh) for float32 input and
// the finishing launch: one translation unit an input form, so that they
// compile side by side.
#include "stream_cols_wide.cuh"

int dn_wcols_f32(int which, const ColsArgs& a) {
  return wcols_launch_form<false, false>(which, a);
}
