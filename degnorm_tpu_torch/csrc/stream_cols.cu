// Kernel 4c's C entry points (and kernel 2c's Gram launch); the kernels are
// stream_cols.cuh, their template instances compiled in
// stream_cols_<f32|i16|tol>.cu, and for 33 <= p <= 128 the wide instances
// of stream_cols_wide.cuh (stream_cols_wide_<f32|i16|tol>.cu), whose sweep
// block is DN_WCR_THREADS threads and whose launches (b) and (c) are two
// kernels each: the power step once a gene, then the blocks' sweep (or E).
// Every launch has G * nb blocks of `threads`: nb blocks a gene.  A gene's
// packed partial Gram is NG = PMAX (PMAX + 1) / 2 floats (PMAX the
// template instance of p).
#include "stream_cols_wide.cuh"

static int cols_dispatch(int f_is_i16, int which, const ColsArgs& a) {
  if (a.threads % 32 != 0 || a.threads < 32 || a.p < 1 ||
      a.p > DN_WIDE_MAX_P || a.nb < 1 || a.S < 0 ||
      (size_t)a.G * a.nb > 0x7fffffffu)
    return (int)cudaErrorInvalidValue;
  if (a.G == 0) return 0;
  // (a) and (b) sum a gene's blocks through bpart and its ticket
  if (which < 2 && a.nb > 1 && (a.bpart == nullptr || a.tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  if (a.p >= DN_WIDE_MIN_P) {
    if (which == 2 && a.s_fin == nullptr) return (int)cudaErrorInvalidValue;
    if (a.tol > 0.f && which > 0) return dn_wcols_tol(f_is_i16, which, a);
    return f_is_i16 ? dn_wcols_i16(which, a) : dn_wcols_f32(which, a);
  }
  if (a.tol > 0.f && which > 0) return dn_cols_tol(f_is_i16, which, a);
  return f_is_i16 ? dn_cols_i16(which, a) : dn_cols_f32(which, a);
}

// (a) X = A0 (skipped where X is null: kernel 2c) and each gene's partial
// Gram of A0 over the shard's columns into gram (G, NG); ncols (G, zeroed
// by the caller) receives each gene's last active column + 1.  F: (G, p, W)
// int16 (f_is_i16; divided by `scale` where it is given) or float32.  nb >
// 1: bpart (G, nb, NG) the blocks' partials, tickets (G) zeroed.
extern "C" int dn_cols_gram(const void* F, int f_is_i16, const uint8_t* mask,
                            const uint8_t* act, const float* scale, float* X,
                            float* gram, float* bpart, int* tickets,
                            int* ncols, int G, int p, int W, int nb,
                            int threads, void* stream) {
  ColsArgs a = {};
  a.F = F;
  a.mask = mask;
  a.act = act;
  a.scale = scale;
  a.X = X;
  a.gram = gram;
  a.bpart = bpart;
  a.tickets = tickets;
  a.ncols = ncols;
  a.G = G;
  a.p = p;
  a.W = W;
  a.nb = nb;
  a.threads = threads;
  a.st = (cudaStream_t)stream;
  return cols_dispatch(f_is_i16, 0, a);
}

// (b) u_out = power step on the S shards' partials `parts` (S, G, NG)
// summed in shard order, from u_in (null: the cold start), one merged sweep
// of X, this shard's next partial Gram into gram (G, NG).  tol > 0: the
// adaptive instance, s carried in s_in / s_out (G), the frozen genes in done
// (G, zeroed by the caller), `it` the iteration.
extern "C" int dn_cols_sweep(const void* F, int f_is_i16, const uint8_t* mask,
                             const uint8_t* act, const float* scale, float* X,
                             const float* parts, int S, int* ncols,
                             const float* u_in, float* u_out, float* gram,
                             float* bpart, int* tickets, const float* s_in,
                             float* s_out, uint8_t* done, float tol, int it,
                             int G, int p, int W, int nmf_iter, int n_squared,
                             int n_plain, int nb, int threads, void* stream) {
  ColsArgs a = {};
  a.F = F;
  a.mask = mask;
  a.act = act;
  a.scale = scale;
  a.X = X;
  a.parts = parts;
  a.S = S;
  a.ncols = ncols;
  a.u_in = u_in;
  a.u_out = u_out;
  a.gram = gram;
  a.bpart = bpart;
  a.tickets = tickets;
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
  a.nb = nb;
  a.threads = threads;
  a.st = (cudaStream_t)stream;
  return cols_dispatch(f_is_i16, 1, a);
}

// (c) u, s refit from the S shards' partials `parts` summed; K = u s (G,
// p), E = X^T u / (s + eps) on the shard's columns (G, W), u_out.  tol > 0:
// a gene frozen in done keeps s_in and u_in.  s_fin (G): the wide
// instances' s between their two kernels (unused at p <= 32).
extern "C" int dn_cols_finish(const uint8_t* mask, const uint8_t* act,
                              const float* X, const float* parts, int S,
                              int* ncols, const float* u_in, float* K,
                              float* E, float* u_out, const float* s_in,
                              float* s_fin, const uint8_t* done, float tol,
                              int G, int p, int W, int n_squared, int n_plain,
                              int nb, int threads, void* stream) {
  ColsArgs a = {};
  a.mask = mask;
  a.act = act;
  a.X = (float*)X;
  a.parts = parts;
  a.S = S;
  a.ncols = ncols;
  a.u_in = u_in;
  a.K = K;
  a.E = E;
  a.u_out = u_out;
  a.s_in = s_in;
  a.s_fin = s_fin;
  a.done = (uint8_t*)done;
  a.tol = tol;
  a.G = G;
  a.p = p;
  a.W = W;
  a.n_squared = n_squared;
  a.n_plain = n_plain;
  a.nb = nb;
  a.threads = threads;
  a.st = (cudaStream_t)stream;
  return cols_dispatch(0, 2, a);
}
