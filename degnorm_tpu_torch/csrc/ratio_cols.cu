// Kernel 2c: ratio-SVD row sums of a COLUMN-SHARDED gene bucket, cut at its
// reductions, one thread block a gene over the shard's columns.
//
// Replaces no Pallas kernel: the JAX package initialises a column-sharded
// bucket on its XLA path (degnorm_tpu/engine.py:75-84), with GSPMD's
// all-reduces at the reduction points.  Kernel 2 (ratio.cuh) sums a gene's
// Gram over a cluster of blocks; a shard holds only some of the gene's
// columns, so the work is cut in two launches with a sum across the shards
// after each (degnorm_tpu_torch/parallel/seqpar.py):
//   1. stream_cols.cuh's cols_gram_kernel with no X: each gene's partial
//      Gram of A0 = F * mask over the shard;
//   2. ratio_cols_sums_kernel (here): the cold power step on the SUMMED Gram
//      from 1 / sqrt(p) (every block of every shard the same step on the
//      same bits), s, K = u s, then per column x = A0, e = x^T u / (s + eps),
//      and the partial row sums of A0 and of max(K e, A0) into (G, 2p).
// The arithmetic is kernel 2's, in its order (ratio.cuh, pass 2).
//
// What bounds it on this card: bytes, as kernel 2 (2p bytes a column of
// int16, read twice: once a launch).  Simple first: the second read of the
// coverage is not avoided, and a block is one gene.
#include "stream_cols.cuh"

template <int PMAX, bool I16>
__global__ void __launch_bounds__(32 * dn_max_warps<PMAX>())
    ratio_cols_sums_kernel(const void* __restrict__ F,
                           const uint8_t* __restrict__ mask,
                           const float* __restrict__ B,
                           float* __restrict__ sums, int p, int W,
                           int power_cold) {
  __shared__ float part[dn_max_warps<PMAX>()][2 * PMAX];
  __shared__ float sK[PMAX], su[PMAX];
  __shared__ float s_s;
  const size_t g = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31,
            warp = tid >> 5;
  if (warp == 0) {
    float row[PMAX], s = 0.f;
    cols_gram_row<PMAX>(B + g * p * p, p, lane, row);
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
  float rs[PMAX], es[PMAX];
#pragma unroll
  for (int i = 0; i < PMAX; ++i) rs[i] = es[i] = 0.f;
  for (int l0 = warp * 32; l0 < W; l0 += nt) {
    const int l = l0 + lane;
    if (l >= W || mg[l] == 0) continue;
    float x[PMAX];
#pragma unroll
    for (int i = 0; i < PMAX; ++i) {
      const size_t at = (g * p + i) * (size_t)W + l;
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
    float t = 0.f;
    for (int w = 0; w < (nt >> 5); ++w) t += part[w][half + i];
    sums[g * 2 * p + k] = t;
  }
}

template <int PM, bool I16>
static int ratio_cols_launch(const void* F, const uint8_t* mask,
                             const float* B, float* sums, int G, int p, int W,
                             int power_cold, int threads, cudaStream_t st) {
  if (threads > 32 * dn_max_warps<PM>()) return (int)cudaErrorInvalidValue;
  ratio_cols_sums_kernel<PM, I16><<<(unsigned)G, threads, 0, st>>>(
      F, mask, B, sums, p, W, power_cold);
  return (int)cudaGetLastError();
}

template <bool I16>
static int ratio_cols_form(const void* F, const uint8_t* mask, const float* B,
                           float* sums, int G, int p, int W, int power_cold,
                           int threads, cudaStream_t st) {
#define DN_RC_ARGS F, mask, B, sums, G, p, W, power_cold, threads, st
  if (p <= 4) return ratio_cols_launch<4, I16>(DN_RC_ARGS);
  if (p <= 8) return ratio_cols_launch<8, I16>(DN_RC_ARGS);
  if (p <= 16) return ratio_cols_launch<16, I16>(DN_RC_ARGS);
  return ratio_cols_launch<32, I16>(DN_RC_ARGS);
#undef DN_RC_ARGS
}

// Launch 2 of kernel 2c: F (G, p, W) int16 (f_is_i16, as it is) or float32;
// B (G, p, p) the summed Gram of launch 1 (dn_cols_gram with no X); sums
// (G, 2p): the partial row sums of A0, then of max(K E, A0).
extern "C" int dn_ratio_cols_sums(const void* F, int f_is_i16,
                                  const uint8_t* mask, const float* B,
                                  float* sums, int G, int p, int W,
                                  int power_cold, int threads, void* stream) {
  if (threads % 32 != 0 || threads < 32 || p < 1 || p > 32)
    return (int)cudaErrorInvalidValue;
  if (G == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return f_is_i16 ? ratio_cols_form<true>(F, mask, B, sums, G, p, W,
                                          power_cold, threads, st)
                  : ratio_cols_form<false>(F, mask, B, sums, G, p, W,
                                           power_cold, threads, st);
}
