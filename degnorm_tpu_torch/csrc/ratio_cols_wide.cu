// Kernel 2c's wide instances (stream_cols_wide.cuh; its first launch is
// kernel 4c's wcols_gram_kernel with no X, in stream_cols_wide_<f32|i16>.cu):
// the cold power step once a gene (wcols_refit_kernel) and the row-sum pass
// (wratio_cols_sums_kernel) for both input forms, in a translation unit of
// their own.
#include "stream_cols_wide.cuh"

template <int PM, bool I16>
static int wratio_launch(const void* F, const uint8_t* mask,
                         const float* parts, int S, const int* ncols,
                         float* sums, float* bpart, int* tickets, float* ws,
                         int G, int p, int W, int power_cold, int nb,
                         int threads, cudaStream_t st) {
  using A = typename std::conditional<I16, int16_t, float>::type;
  if (!wcols_geometry_ok(W, nb, threads)) return (int)cudaErrorInvalidValue;
  // ws: u (G, p), K (G, p), s (G)
  float* u = ws;
  float* K = ws + (size_t)G * p;
  float* s = K + (size_t)G * p;
  ColsArgs a = {};
  a.parts = parts;
  a.S = S;
  a.G = G;
  a.p = p;
  a.st = st;
  const int r = wcols_refit_launch<PM, false>(a, nullptr, u, nullptr, s,
                                              nullptr, K, power_cold, 0);
  if (r != 0) return r;
  constexpr int NS = wcr_stages(PM, (int)sizeof(A));
  static_assert(wcr_dyn_bytes(PM, (int)sizeof(A), NS) <= wcr_budget(PM),
                "the ring and the rest fit the block's share of the SM");
  const size_t dyn = wcr_dyn_bytes(PM, (int)sizeof(A), NS);
  const cudaError_t e = cols_prepare(wratio_cols_sums_kernel<PM, I16>, dyn);
  if (e != cudaSuccess) return (int)e;
  wratio_cols_sums_kernel<PM, I16>
      <<<(unsigned)((size_t)G * nb), DN_WCR_THREADS, dyn, st>>>(
          F, mask, ncols, u, K, s, sums, bpart, tickets, p, W, nb);
  return (int)cudaGetLastError();
}

int dn_wratio_cols(const void* F, int f_is_i16, const uint8_t* mask,
                   const float* parts, int S, const int* ncols, float* sums,
                   float* bpart, int* tickets, float* ws, int G, int p, int W,
                   int power_cold, int nb, int threads, cudaStream_t st) {
#define DN_WRC_CALL(PM)                                                     \
  return f_is_i16 ? wratio_launch<PM, true>(F, mask, parts, S, ncols, sums, \
                                            bpart, tickets, ws, G, p, W,    \
                                            power_cold, nb, threads, st)    \
                  : wratio_launch<PM, false>(F, mask, parts, S, ncols,      \
                                             sums, bpart, tickets, ws, G,   \
                                             p, W, power_cold, nb, threads, \
                                             st)
  DN_DISPATCH_WIDE_P(p, DN_WRC_CALL);
#undef DN_WRC_CALL
  return (int)cudaErrorInvalidValue;  // not reached
}
