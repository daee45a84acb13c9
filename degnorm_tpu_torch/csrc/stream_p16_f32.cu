// Kernel 4 (stream.cuh), the instances for PMAX = 16 and finished float32
// input: one translation unit a (PMAX, input form), so that they compile side
// by side.
#include "stream.cuh"

int dn_stream_p16_f32(const StreamArgs& a) {
  return launch_streamed_full<16, false>(a);
}
