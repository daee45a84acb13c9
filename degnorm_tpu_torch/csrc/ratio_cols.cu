// Kernel 2c: ratio-SVD row sums of a COLUMN-SHARDED gene bucket, cut at its
// reductions, a gene's columns of the shard spread over `nb` thread blocks.
//
// Replaces no Pallas kernel: the JAX package initialises a column-sharded
// bucket on its XLA path (degnorm_tpu/engine.py:75-84), with GSPMD's
// all-reduces at the reduction points.  Kernel 2 (ratio.cuh) sums a gene's
// Gram over a cluster of blocks; a shard holds only some of the gene's
// columns, so the work is cut in two launches:
//   1. stream_cols.cuh's cols_gram_kernel with no X: each gene's partial
//      Gram of A0 = F * mask over the shard, and its last active column;
//   2. ratio_cols_sums_kernel (here): every shard's partial of launch 1
//      summed in shard order (parallel/seqpar.py, Columns.gather_: the sum
//      across the shards is inside this launch), the cold power step on it
//      from 1 / sqrt(p) (every block of every shard the same step on the
//      same bits), s, K = u s, then per column x = A0, e = x^T u / (s +
//      eps), and the partial row sums of A0 and of max(K e, A0) into
//      (G, 2p), which the host sums across the shards.
// The arithmetic is kernel 2's, in its order (ratio.cuh, pass 2).
//
// What bounds it on this card: bytes, as kernel 2 (2p bytes a column of
// int16, read once a launch), where the bucket's genes fill the card; on a
// bucket of one to three outlier genes, latency, which the spread over
// blocks answers: a gene's columns are dealt to nb blocks in chunks of
// DN_STREAM_CHUNK (stream_cols.cuh), and the blocks' partials meet in block
// order through the gene's integer ticket (cols_gene_store).  The second
// read of the coverage stays (a launch cannot keep it past the sum across
// the shards).
#include "stream_cols_wide.cuh"

template <int PMAX, bool I16>
__global__ void __launch_bounds__(32 * dn_max_warps<PMAX>(),
                                  cols_min_blocks<PMAX>())
    ratio_cols_sums_kernel(const void* __restrict__ F,
                           const uint8_t* __restrict__ mask,
                           const float* __restrict__ parts, int S,
                           const int* __restrict__ ncols,
                           float* __restrict__ sums, float* bpart,
                           int* tickets, int G, int p, int W, int power_cold,
                           int nb) {
  constexpr int NG = cols_ng<PMAX>();
  __shared__ float part[dn_max_warps<PMAX>()][2 * PMAX];
  __shared__ float blk[2 * PMAX];
  __shared__ float sK[PMAX], su[PMAX];
  __shared__ float s_s;
  __shared__ float gram[NG];  // the gene's Gram, summed over the shards
  const ColsBlock b(nb);
  const size_t g = b.g;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31,
            warp = tid >> 5;
  const int nch = (ncols[g] + DN_STREAM_CHUNK - 1) / DN_STREAM_CHUNK;
  const int nact = cols_active_blocks(ncols[g], nb);
  if (b.rank >= nact) return;
  cols_sum_shards<NG>(parts + g * NG, (size_t)G * NG, S, gram);
  __syncthreads();
  if (warp == 0) {
    float row[PMAX], s = 0.f;
    load_gram_row<PMAX>(gram, lane, row);
    float u = lane < p ? 1.0f / sqrtf((float)p) : 0.f;
    u = power_refit<PMAX>(row, u, power_cold, 0, true, s);
    if (lane < PMAX) {
      su[lane] = u;
      sK[lane] = u * s;
    }
    if (lane == 0) s_s = s;
  }
  __syncthreads();
  const float den = s_s + DN_EPS;
  const uint8_t* mg = mask + g * W;
  ColsSrc<PMAX, false, false> src;  // the dealing alone
  src.rank = b.rank;
  src.nb = nb;
  src.deal(nch);
  float rs[PMAX], es[PMAX];
#pragma unroll
  for (int i = 0; i < PMAX; ++i) rs[i] = es[i] = 0.f;
  for (int l0 = warp * 32; l0 < src.nloc; l0 += nt) {
    const int l = l0 + lane, w = src.col(l);
    if (l >= src.nloc || w >= W || mg[w] == 0) continue;
    float x[PMAX];
#pragma unroll
    for (int i = 0; i < PMAX; ++i) {
      const size_t at = (g * p + i) * (size_t)W + w;
      x[i] = i < p ? (I16 ? (float)((const int16_t*)F)[at]
                          : ((const float*)F)[at])
                   : 0.f;
    }
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < PMAX; ++i) v = fmaf(x[i], su[i], v);
    const float e = v / den;
#pragma unroll
    for (int i = 0; i < PMAX; ++i) {
      rs[i] += x[i];
      es[i] += fmaxf(sK[i] * e, x[i]);
    }
  }
  warp_reduce_store<PMAX>(rs, part[warp], lane);
  warp_reduce_store<PMAX>(es, part[warp] + PMAX, lane);
  __syncthreads();
  for (int k = tid; k < 2 * p; k += nt) {
    const int i = k < p ? k : k - p, half = k < p ? 0 : PMAX;
    float t = part[0][half + i];
    for (int w = 1; w < (nt >> 5); ++w) t += part[w][half + i];
    blk[k] = t;
  }
  __syncthreads();
  cols_gene_store(blk, 2 * p, sums + g * 2 * p, bpart + g * nb * 2 * p,
                  tickets + g, b.rank, nact);
}

template <int PM, bool I16>
static int ratio_cols_launch(const void* F, const uint8_t* mask,
                             const float* parts, int S, const int* ncols,
                             float* sums, float* bpart, int* tickets, int G,
                             int p, int W, int power_cold, int nb,
                             int threads, cudaStream_t st) {
  if (threads > 32 * dn_max_warps<PM>()) return (int)cudaErrorInvalidValue;
  ratio_cols_sums_kernel<PM, I16>
      <<<(unsigned)((size_t)G * nb), threads, 0, st>>>(
          F, mask, parts, S, ncols, sums, bpart, tickets, G, p, W,
          power_cold, nb);
  return (int)cudaGetLastError();
}

template <bool I16>
static int ratio_cols_form(const void* F, const uint8_t* mask,
                           const float* parts, int S, const int* ncols,
                           float* sums, float* bpart, int* tickets, int G,
                           int p, int W, int power_cold, int nb, int threads,
                           cudaStream_t st) {
#define DN_RC_ARGS \
  F, mask, parts, S, ncols, sums, bpart, tickets, G, p, W, power_cold, nb, \
      threads, st
  if (p <= 4) return ratio_cols_launch<4, I16>(DN_RC_ARGS);
  if (p <= 8) return ratio_cols_launch<8, I16>(DN_RC_ARGS);
  if (p <= 16) return ratio_cols_launch<16, I16>(DN_RC_ARGS);
  return ratio_cols_launch<32, I16>(DN_RC_ARGS);
#undef DN_RC_ARGS
}

// Launch 2 of kernel 2c: F (G, p, W) int16 (f_is_i16, as it is) or float32;
// parts (S, G, NG) every shard's packed partial Gram of launch 1
// (dn_cols_gram with no X), summed here in shard order; ncols (G) from
// launch 1; sums (G, 2p): this shard's row sums of A0, then of max(K E,
// A0).  nb > 1: bpart (G, nb, 2p) the blocks' partials, tickets (G) zero.
// 33 <= p <= 128: the wide instance (stream_cols_wide.cuh, compiled in
// ratio_cols_wide.cu), DN_WCR_THREADS threads a block, two kernels (the cold
// power step once a gene, then the row sums), ws (G (2p + 1) floats) their
// u, K and s.
extern "C" int dn_ratio_cols_sums(const void* F, int f_is_i16,
                                  const uint8_t* mask, const float* parts,
                                  int S, const int* ncols, float* sums,
                                  float* bpart, int* tickets, float* ws,
                                  int G, int p, int W, int power_cold, int nb,
                                  int threads, void* stream) {
  if (threads % 32 != 0 || threads < 32 || p < 1 || p > DN_WIDE_MAX_P ||
      nb < 1 || S < 1 || (size_t)G * nb > 0x7fffffffu ||
      (nb > 1 && (bpart == nullptr || tickets == nullptr)) ||
      (p >= DN_WIDE_MIN_P && (threads != DN_WCR_THREADS || ws == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (G == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (p >= DN_WIDE_MIN_P)
    return dn_wratio_cols(F, f_is_i16, mask, parts, S, ncols, sums, bpart,
                          tickets, ws, G, p, W, power_cold, nb, threads, st);
  return f_is_i16 ? ratio_cols_form<true>(F, mask, parts, S, ncols, sums,
                                          bpart, tickets, G, p, W,
                                          power_cold, nb, threads, st)
                  : ratio_cols_form<false>(F, mask, parts, S, ncols, sums,
                                           bpart, tickets, G, p, W,
                                           power_cold, nb, threads, st);
}
