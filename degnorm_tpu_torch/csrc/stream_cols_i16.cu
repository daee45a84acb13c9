// Kernel 4c (stream_cols.cuh), the instances for raw int16 input (divided by
// its scales, or by ones): one translation unit an input form, so that they
// compile side by side.
#include "stream_cols.cuh"

int dn_cols_i16(int which, const ColsArgs& a) {
  return cols_launch_form<true, false>(which, a);
}
