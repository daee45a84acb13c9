// Kernel 4's C entry points; the kernel itself is stream.cuh, its template
// instances are compiled in stream_p<PMAX>_<f32|i16>.cu.
#include "stream.cuh"

// X: (G, p, W) float32 scratch.  cl: blocks a gene, 1, 2, 4 or 8.  threads:
// a multiple of 32, at most 512 (256 for p > 8; exactly 256 for p > 32, the
// wide instances of stream_wide.cuh).  p > 128 takes the panel instance
// (stream_panel.cu: cl 1), which also takes ws: on its cluster layout (p <=
// DN_PCL_MAX_P_STREAM) ws_slots workspaces of dn_pcl_ws_floats(p) floats,
// one a cluster in flight, where a block holds several pairs (else null),
// above it (stream_phase.cu) a workspace of dn_phase_ws_floats(p, ws_slots,
// G) floats, ws_slots genes in flight (null and 0 below 129).
extern "C" int dn_nmf_streamed(const void* F, int f_is_i16,
                               const uint8_t* mask, const uint8_t* act,
                               const float* scale, const float* u0, float* X,
                               float* K, float* E, float* u, int G, int p,
                               int W, int nmf_iter, int power_cold,
                               int power_warm, int warm_plain, int cl,
                               int threads, float* ws, int ws_slots,
                               void* stream) {
  if (threads % 32 != 0 || threads < 32 || cl < 1 ||
      cl > DN_STREAM_MAX_CLUSTER || (cl & (cl - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  // two input forms: raw int16 with its scales, or finished float32
  if ((f_is_i16 != 0) != (scale != nullptr)) return (int)cudaErrorInvalidValue;
  StreamArgs a = {F,  mask,     act,        scale,      u0,
                  X,  K,        E,          u,          G,
                  p,  W,        nmf_iter,   power_cold, power_warm,
                  warm_plain,   cl,         threads,
                  (cudaStream_t)stream};
  a.ws = ws;
  a.ws_slots = ws_slots;
  int code;
  if (p > 128)
    code = dn_stream_panel(a);
  else if (p <= 4)
    code = f_is_i16 ? dn_stream_p4_i16(a) : dn_stream_p4_f32(a);
  else if (p <= 8)
    code = f_is_i16 ? dn_stream_p8_i16(a) : dn_stream_p8_f32(a);
  else if (p <= 16)
    code = f_is_i16 ? dn_stream_p16_i16(a) : dn_stream_p16_f32(a);
  else if (p <= 32)
    code = f_is_i16 ? dn_stream_p32_i16(a) : dn_stream_p32_f32(a);
  else
    code = f_is_i16 ? dn_stream_wide_i16(a) : dn_stream_wide_f32(a);
  if (code != 0) return code;
  return (int)cudaGetLastError();
}

// out[i, k] = (float)raw[k] / scale[i] as the sweeps of the int16 + scale
// form compute it: the probe behind the exhaustive quotient check.
__global__ void scaled_quotients_kernel(const int16_t* __restrict__ raw,
                                        const float* __restrict__ scale,
                                        float* __restrict__ out, int n, int p) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  for (int i = 0; i < p; ++i) {
    const float s = scale[i];
    out[(size_t)i * n + k] = scaled_i16(raw[k], s, 1.0f / s);
  }
}

extern "C" int dn_scaled_quotients(const int16_t* raw, const float* scale,
                                   float* out, int n, int p, void* stream) {
  scaled_quotients_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      raw, scale, out, n, p);
  return (int)cudaGetLastError();
}
