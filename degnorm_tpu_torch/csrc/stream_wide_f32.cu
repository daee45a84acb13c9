// Kernel 4 for 33 <= p <= 128 (stream_wide.cuh), the instances for
// float32 input: one translation unit an input form, so that they
// compile side by side.
#include "stream_wide.cuh"

int dn_stream_wide_f32(const StreamArgs& a) {
  return launch_stream_wide<false>(a);
}
