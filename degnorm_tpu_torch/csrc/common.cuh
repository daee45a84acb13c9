// Shared device code of the DegNorm CUDA kernels (sm_90a, plain float32).
//
// Replaces the shared helpers of the TPU kernels in
// degnorm_tpu/ops/pallas_nmf.py (_gram, _power, _power_warm, _rank1_uv,
// _finish_KE, _nmf_loop), which ops/pallas_trim.py imports the same way
// this header is included by nmf.cu, ratio.cu, trim.cu and stream.cu.
//
// Design: ONE THREAD BLOCK PER GENE (stream.cu, for wide genes, spreads a
// gene over a cluster of blocks and shares the helpers below).  Threads stride over the W columns of
// the gene's (p, W) matrix; a thread holds one column's p values in
// registers, so one pass per Lagrangian iteration does everything that
// touches the wide axis: v_w = sum_i X[i,w] u_i (the previous iterate's
// right vector, never stored), the X-form multiplier update, and the
// p(p+1)/2 Gram partial sums of the new X.  The Gram partials are reduced
// across the block (warp shuffles, then a fixed-order sum over warps: the
// result does not depend on scheduling), and warp 0 runs the p x p power
// iteration with lane i holding row i of the Gram in registers.
//
// What bounds it on this card: operations, not bytes.  A gene is read once
// and one E row is written, but each of nmf_iter iterations does about
// p(p+1) + 8p float32 operations per column.  X lives in a global scratch
// tensor; at the main path's shapes (p=8, W<=4096: <=128 KB a gene) the
// blocks in flight keep X and the coverage in the 50 MB L2, so device
// memory sees one read of F.  Columns outside the mask are skipped.
//
// p is a runtime value; the kernels are instantiated for PMAX in
// {4, 8, 16, 32} and rows p..PMAX-1 are carried as zeros (zero Gram rows,
// zero u entries), which is exact.
//
// No -use_fast_math: the code relies on exact == 0.0f tests, on 1e-30 as a
// regulariser and on IEEE divide and sqrt.  Products that feed an exact
// test use __fmul_rn so that FMA contraction cannot change the test.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define DN_EPS 1e-30f
#define DN_MAX_WARPS 8
#define DN_FULL 0xffffffffu

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(DN_FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(DN_FULL, v, o));
  return v;
}

// Per-block shared workspace of the rank-1 machinery; MAXW is the most
// warps a block of the kernel may have.
template <int PMAX, int MAXW = DN_MAX_WARPS>
struct NmfSmem {
  static constexpr int NG = PMAX * (PMAX + 1) / 2;  // packed upper triangle
  static constexpr int NR = NG + 2 * PMAX;          // widest reduction
  float part[MAXW * NR];          // per-warp partial sums
  float red[NR];                  // reduced values (read by warp 0)
  float u[PMAX];                  // unit left vector
  float K[PMAX];                  // u * s
  float s;                        // singular value
  float sumE;                     // sum_w E[w] of the last finish pass
};

// Block-wide sum of N per-thread values into out[0..N).  Only warp 0 may
// read `out` when this returns; the caller must __syncthreads() before
// `part` or `out` are written again and before other warps read `out`.
template <int N>
__device__ __forceinline__ void block_reduce(const float (&acc)[N], float* part,
                                             float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float v = warp_sum(acc[k]);
    if (lane == 0) part[warp * N + k] = v;
  }
  __syncthreads();
  if (warp == 0) {
    for (int k = lane; k < N; k += 32) {
      float s = 0.f;
      for (int w = 0; w < nw; ++w) s += part[w * N + k];
      out[k] = s;
    }
    __syncwarp();
  }
}

// acc += upper triangle of x x^T (row-major packed, j >= i).
template <int PMAX>
__device__ __forceinline__ void gram_accumulate(const float (&x)[PMAX],
                                                float* acc) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < PMAX; ++i) {
#pragma unroll
    for (int j = i; j < PMAX; ++j) {
      acc[k] = fmaf(x[i], x[j], acc[k]);
      ++k;
    }
  }
}

// Lane `lane` of warp 0 loads row `lane` of the symmetric Gram from its
// packed upper triangle; lanes >= PMAX get zeros.
template <int PMAX>
__device__ __forceinline__ void load_gram_row(const float* packed, int lane,
                                              float (&row)[PMAX]) {
#pragma unroll
  for (int j = 0; j < PMAX; ++j) {
    int a = lane < j ? lane : j, b = lane < j ? j : lane;
    int idx = a * PMAX - (a * (a - 1)) / 2 + (b - a);
    row[j] = (lane < PMAX) ? packed[idx] : 0.f;
  }
}

// Row of B / (max|B| + eps), the max taken over the whole matrix.
template <int PMAX>
__device__ __forceinline__ void normalize_rows(const float (&row)[PMAX],
                                               float (&out)[PMAX]) {
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < PMAX; ++j) m = fmaxf(m, fabsf(row[j]));
  m = warp_max(m);
#pragma unroll
  for (int j = 0; j < PMAX; ++j) out[j] = row[j] / (m + DN_EPS);
}

// y_lane = sum_j M[lane][j] * x_j, with x_j held by lane j.
template <int PMAX>
__device__ __forceinline__ float warp_matvec(const float (&row)[PMAX], float x) {
  float y = 0.f;
#pragma unroll
  for (int j = 0; j < PMAX; ++j) y = fmaf(row[j], __shfl_sync(DN_FULL, x, j), y);
  return y;
}

__device__ __forceinline__ float renormalize(float w, float u_prev) {
  float nrm = sqrtf(warp_sum(w * w));
  return nrm > DN_EPS ? w / (nrm + DN_EPS) : u_prev;
}

// Squared-operator power iteration (cold start; also the warm scheme when
// warm_plain == 0): normalize, square once, max(1, n_iters / 4) bodies of
// two B^2 applications.  Whole warp 0 must call this.
template <int PMAX>
__device__ __forceinline__ float power_squared(const float (&row)[PMAX], float u,
                                               int n_iters) {
  float bn[PMAX], b2[PMAX];
  normalize_rows<PMAX>(row, bn);
#pragma unroll
  for (int j = 0; j < PMAX; ++j) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < PMAX; ++k)  // Bn[k][j] == Bn[j][k]: lane j's entry k
      s = fmaf(bn[k], __shfl_sync(DN_FULL, bn[k], j), s);
    b2[j] = s;
  }
  int n_bodies = n_iters / 4;
  if (n_bodies < 1) n_bodies = 1;
  for (int it = 0; it < n_bodies; ++it) {
    float v = warp_matvec<PMAX>(b2, u);
    float w = warp_matvec<PMAX>(b2, v);
    u = renormalize(w, u);
  }
  return u;
}

// Warm restart: n plain matvecs on the normalized Gram, one normalization.
template <int PMAX>
__device__ __forceinline__ float power_plain(const float (&row)[PMAX], float u,
                                             int n) {
  float bn[PMAX];
  normalize_rows<PMAX>(row, bn);
  float w = u;
  for (int it = 0; it < n; ++it) w = warp_matvec<PMAX>(bn, w);
  return renormalize(w, u);
}

// Warp 0: refit u from the packed Gram in sm.red; with `finish`, also
// s = sqrt(max(u^T B u, 0)) and K = u * s.
template <int PMAX, int MAXW>
__device__ __forceinline__ void warp0_refit(NmfSmem<PMAX, MAXW>& sm,
                                            int n_squared, int n_plain,
                                            bool finish) {
  const int lane = threadIdx.x & 31;
  float row[PMAX];
  load_gram_row<PMAX>(sm.red, lane, row);
  float u = lane < PMAX ? sm.u[lane] : 0.f;
  u = n_plain > 0 ? power_plain<PMAX>(row, u, n_plain)
                  : power_squared<PMAX>(row, u, n_squared);
  if (finish) {
    float bu = warp_matvec<PMAX>(row, u);
    float s = sqrtf(fmaxf(warp_sum(u * bu), 0.f));
    if (lane < PMAX) sm.K[lane] = u * s;
    if (lane == 0) sm.s = s;
  }
  if (lane < PMAX) sm.u[lane] = u;
}

// The whole Lagrangian NMF-OA loop for this block's gene.
//   F, X: (p, W) rows of this gene (X is scratch); mask: (W) bytes;
//   E: (W) output row.
// mask, X and E carry no __restrict__: the trim kernel rewrites its column
// mask and E between calls, so their loads must not take the read-only path.
// Pre: sm.u holds the start vector (zeros beyond p) and a __syncthreads()
// has passed since it was written.  Post (after the closing
// __syncthreads()): sm.u, sm.K, sm.s, sm.sumE are valid for every thread
// and E is written.
template <int PMAX>
__device__ void nmf_loop(NmfSmem<PMAX>& sm, const float* __restrict__ F,
                         const uint8_t* mask, float* X, float* E, int p, int W, int nmf_iter,
                         int power_cold, int power_warm, int warm_plain) {
  constexpr int NG = NmfSmem<PMAX>::NG;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5;
  const float step =
      nmf_iter > 0 ? (float)(1.0 / sqrt((double)nmf_iter)) : 0.f;
  float acc[NG];
  float u[PMAX];

  // pass 0: X = A0 = F * mask, Gram of A0
#pragma unroll
  for (int k = 0; k < NG; ++k) acc[k] = 0.f;
  for (int w = tid; w < W; w += nt) {
    float x[PMAX];
    const bool m = mask[w] != 0;
#pragma unroll
    for (int i = 0; i < PMAX; ++i) {
      x[i] = (m && i < p) ? F[(size_t)i * W + w] : 0.f;
      if (i < p) X[(size_t)i * W + w] = x[i];
    }
    if (m) gram_accumulate<PMAX>(x, acc);
  }
  block_reduce<NG>(acc, sm.part, sm.red);
  if (warp == 0) warp0_refit<PMAX>(sm, power_cold, 0, nmf_iter == 0);
  __syncthreads();

  for (int it = 0; it < nmf_iter; ++it) {
#pragma unroll
    for (int i = 0; i < PMAX; ++i) u[i] = sm.u[i];
#pragma unroll
    for (int k = 0; k < NG; ++k) acc[k] = 0.f;
    for (int w = tid; w < W; w += nt) {
      if (mask[w] == 0) continue;  // column stays exactly zero
      float x[PMAX], a[PMAX];
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < PMAX; ++i) {
        x[i] = i < p ? X[(size_t)i * W + w] : 0.f;
        a[i] = i < p ? F[(size_t)i * W + w] : 0.f;
        v = fmaf(x[i], u[i], v);
      }
#pragma unroll
      for (int i = 0; i < PMAX; ++i) {
        // X <- max(X - step * (u_i v - A0), A0)
        x[i] = fmaxf(x[i] - step * (u[i] * v - a[i]), a[i]);
        if (i < p) X[(size_t)i * W + w] = x[i];
      }
      gram_accumulate<PMAX>(x, acc);
    }
    block_reduce<NG>(acc, sm.part, sm.red);
    if (warp == 0)
      warp0_refit<PMAX>(sm, power_warm, warm_plain, it == nmf_iter - 1);
    __syncthreads();
  }

  // finish: E = X^T u / (s + eps), and its sum
#pragma unroll
  for (int i = 0; i < PMAX; ++i) u[i] = sm.u[i];
  const float s = sm.s;
  float se[1] = {0.f};
  for (int w = tid; w < W; w += nt) {
    float e = 0.f;
    if (mask[w] != 0) {
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < PMAX; ++i)
        v = fmaf(i < p ? X[(size_t)i * W + w] : 0.f, u[i], v);
      e = v / (s + DN_EPS);
    }
    E[w] = e;
    se[0] += e;
  }
  block_reduce<1>(se, sm.part, sm.red);
  if (tid == 0) sm.sumE = sm.red[0];
  __syncthreads();
}

// p -> template instantiation
#define DN_DISPATCH_P(p, CALL) \
  do {                         \
    if ((p) <= 4) {            \
      CALL(4);                 \
    } else if ((p) <= 8) {     \
      CALL(8);                 \
    } else if ((p) <= 16) {    \
      CALL(16);                \
    } else {                   \
      CALL(32);                \
    }                          \
  } while (0)
