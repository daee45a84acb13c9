// Kernel 4 (stream.cuh), the instances for PMAX = 32 and raw int16 + scale
// input: one translation unit a (PMAX, input form), so that they compile side
// by side.
#include "stream.cuh"

int dn_stream_p32_i16(const StreamArgs& a) {
  return launch_streamed_full<32, true>(a);
}
