// Kernel 4c's C entry points (and kernel 2c's Gram launch); the kernels are
// stream_cols.cuh, their template instances compiled in
// stream_cols_<f32|i16>.cu.
#include "stream_cols.cuh"

static int cols_dispatch(int f_is_i16, int which, const ColsArgs& a) {
  if (a.threads % 32 != 0 || a.threads < 32 || a.p < 1 || a.p > 32)
    return (int)cudaErrorInvalidValue;
  if (a.G == 0) return 0;
  if (a.tol > 0.f && which > 0) return dn_cols_tol(f_is_i16, which, a);
  return f_is_i16 ? dn_cols_i16(which, a) : dn_cols_f32(which, a);
}

// (a) X = A0 (skipped where X is null: kernel 2c) and each gene's partial
// Gram of A0 over the shard's columns into gram (G, p, p).  F: (G, p, W)
// int16 (f_is_i16; divided by `scale` where it is given) or float32.
extern "C" int dn_cols_gram(const void* F, int f_is_i16, const uint8_t* mask,
                            const uint8_t* act, const float* scale, float* X,
                            float* gram, int G, int p, int W, int threads,
                            void* stream) {
  ColsArgs a = {};
  a.F = F;
  a.mask = mask;
  a.act = act;
  a.scale = scale;
  a.X = X;
  a.gram = gram;
  a.G = G;
  a.p = p;
  a.W = W;
  a.threads = threads;
  a.st = (cudaStream_t)stream;
  return cols_dispatch(f_is_i16, 0, a);
}

// (b) u_out = power step on the summed Gram B (G, p, p) from u_in (null:
// the cold start), one merged sweep of X, next partial Gram into gram.
// tol > 0: the adaptive instance, s carried in s_in / s_out (G), the frozen
// genes in done (G, zeroed by the caller), `it` the iteration.
extern "C" int dn_cols_sweep(const void* F, int f_is_i16, const uint8_t* mask,
                             const uint8_t* act, const float* scale, float* X,
                             const float* B, const float* u_in, float* u_out,
                             float* gram, const float* s_in, float* s_out,
                             uint8_t* done, float tol, int it, int G, int p,
                             int W, int nmf_iter, int n_squared, int n_plain,
                             int threads, void* stream) {
  ColsArgs a = {};
  a.F = F;
  a.mask = mask;
  a.act = act;
  a.scale = scale;
  a.X = X;
  a.B = B;
  a.u_in = u_in;
  a.u_out = u_out;
  a.gram = gram;
  a.s_in = s_in;
  a.s_out = s_out;
  a.done = done;
  a.tol = tol;
  a.it = it;
  a.G = G;
  a.p = p;
  a.W = W;
  a.nmf_iter = nmf_iter;
  a.n_squared = n_squared;
  a.n_plain = n_plain;
  a.threads = threads;
  a.st = (cudaStream_t)stream;
  return cols_dispatch(f_is_i16, 1, a);
}

// (c) u, s refit from the summed Gram B; K = u s (G, p), E = X^T u / (s +
// eps) on the shard's columns (G, W), u_out.  tol > 0: a gene frozen in
// done keeps s_in and u_in.
extern "C" int dn_cols_finish(const uint8_t* mask, const uint8_t* act,
                              const float* X, const float* B,
                              const float* u_in, float* K, float* E,
                              float* u_out, const float* s_in,
                              const uint8_t* done, float tol, int G, int p,
                              int W, int n_squared, int n_plain, int threads,
                              void* stream) {
  ColsArgs a = {};
  a.mask = mask;
  a.act = act;
  a.X = (float*)X;
  a.B = B;
  a.u_in = u_in;
  a.K = K;
  a.E = E;
  a.u_out = u_out;
  a.s_in = s_in;
  a.done = (uint8_t*)done;
  a.tol = tol;
  a.G = G;
  a.p = p;
  a.W = W;
  a.n_squared = n_squared;
  a.n_plain = n_plain;
  a.threads = threads;
  a.st = (cudaStream_t)stream;
  return cols_dispatch(0, 2, a);
}
