// Kernel 4c (stream_cols.cuh), the instances for float32 input and the
// finishing launch: one translation unit an input form, so that they compile
// side by side.
#include "stream_cols.cuh"

int dn_cols_f32(int which, const ColsArgs& a) {
  return cols_launch_form<false, false>(which, a);
}
