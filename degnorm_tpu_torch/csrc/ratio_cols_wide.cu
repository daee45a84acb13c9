// Kernel 2c's wide instances (stream_cols_wide.cuh's
// wratio_cols_sums_kernel; its first launch is kernel 4c's
// wcols_gram_kernel with no X, in stream_cols_wide_<f32|i16>.cu): the
// second launch for both input forms, in a translation unit of its own.
#include "stream_cols_wide.cuh"

template <int PM, bool I16>
static int wratio_launch(const void* F, const uint8_t* mask,
                         const float* parts, int S, const int* ncols,
                         float* sums, float* bpart, int* tickets, int G,
                         int p, int W, int power_cold, int nb,
                         cudaStream_t st) {
  const size_t dyn = wcols_dyn_bytes<PM>();
  const cudaError_t e = cols_prepare(wratio_cols_sums_kernel<PM, I16>, dyn);
  if (e != cudaSuccess) return (int)e;
  wratio_cols_sums_kernel<PM, I16>
      <<<(unsigned)((size_t)G * nb), DN_WIDE_THREADS, dyn, st>>>(
          F, mask, parts, S, ncols, sums, bpart, tickets, G, p, W,
          power_cold, nb);
  return (int)cudaGetLastError();
}

int dn_wratio_cols(const void* F, int f_is_i16, const uint8_t* mask,
                   const float* parts, int S, const int* ncols, float* sums,
                   float* bpart, int* tickets, int G, int p, int W,
                   int power_cold, int nb, cudaStream_t st) {
#define DN_WRC_CALL(PM)                                                     \
  return f_is_i16 ? wratio_launch<PM, true>(F, mask, parts, S, ncols, sums, \
                                            bpart, tickets, G, p, W,        \
                                            power_cold, nb, st)             \
                  : wratio_launch<PM, false>(F, mask, parts, S, ncols,      \
                                             sums, bpart, tickets, G, p, W, \
                                             power_cold, nb, st)
  DN_DISPATCH_WIDE_P(p, DN_WRC_CALL);
#undef DN_WRC_CALL
  return (int)cudaErrorInvalidValue;  // not reached
}
