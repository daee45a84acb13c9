// Kernel 4 (stream.cuh), the instances for PMAX = 8 and finished float32
// input: one translation unit a (PMAX, input form), so that they compile side
// by side.
#include "stream.cuh"

int dn_stream_p8_f32(const StreamArgs& a) {
  return launch_streamed_full<8, false>(a);
}
