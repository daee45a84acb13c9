// Kernel 4c: the NMF-OA loop of a COLUMN-SHARDED gene bucket, cut at its
// reductions, one thread block a gene over the shard's columns.  Kernel 2c
// (ratio_cols.cu) shares its Gram launch.
//
// Replaces no Pallas kernel: on a mesh the JAX package runs such a bucket
// on its XLA path (degnorm_tpu/engine.py:75-84, _seqpar_safe), and GSPMD
// places one all-reduce at each reduction point (parallel/seqpar.py:1-26).
// Kernel 4 (stream.cuh) reduces the p x p Gram of each sweep across a
// gene's columns inside one cluster; a shard holds only some of them, so
// the loop is cut where the Gram is summed and the sum crosses the shards
// between launches (degnorm_tpu_torch/parallel/seqpar.py):
//   (a) cols_gram_kernel: X = A0 = F * mask (A0 of kernel 4's input forms:
//       float32, or raw int16 divided by `scale` exactly as stream.cuh's
//       scaled_i16 does) and the gene's partial Gram of A0 over the shard;
//   (b) cols_sweep_kernel, once an iteration: u refit by the power step on
//       the SUMMED Gram (every warp of every shard runs the same step on the
//       same bits, so u is bit-equal everywhere with no broadcast), one
//       merged sweep X <- max(X - step (u (u^T X) - A0), A0) over the
//       shard's columns, and the partial Gram of the new X;
//   (c) cols_finish_kernel: u and s refit from the last summed Gram, K = u s,
//       E = X^T u / (s + eps) on the shard's columns.
// The arithmetic of each step is common.cuh's (nmf_core's sweep,
// power_refit), in the same order.  ADAPT (EngineConfig.nmf_tol > 0, which
// the JAX package's XLA path honours at any width): nmf_core's adaptive
// branch cut the same way: (b) refits u and s, freezes a gene after the
// first refit with max|K_new - K_old| <= tol max(max|K|, 1e-30) (that
// refit kept, `done` set, its partials zero from then on) and sweeps with
// est = u_i s (v / (s + eps)); (c) takes a frozen gene's u and s as they
// are.
//
// What bounds it on this card: bytes.  A sweep reads and writes X in device
// memory (8 bytes an element) and reads A0 again (2 or 4), where kernel 4
// keeps both in shared memory for the whole loop; at the long tail's
// W = 65,536 bucket that is about 10 p W bytes a gene a sweep.  Beside it a
// launch and a reduction a sweep.  Simple first: no clusters, no copy of X
// in shared memory, the mask byte read each sweep; fusing the reduction and
// CUDA graphs are later work.
//
// A gene outside `act` writes a zero partial Gram (and zero u, K, E), so
// every shard reduces as often as the others whatever its genes.
#pragma once

#include "common.cuh"
#include "stream.cuh"  // scaled_i16

// The p x p partial Gram a gene, in full (both triangles, the same sums), so
// that it is summed across the shards as a plain (G, p, p) tensor.
template <int PMAX, int MAXW>
__device__ __forceinline__ void cols_block_gram(float (&part)[MAXW][PMAX * (PMAX + 1) / 2],
                                                float* __restrict__ out,
                                                int p) {
  const int nw = blockDim.x >> 5;
  for (int k = threadIdx.x; k < p * p; k += blockDim.x) {
    const int a = k / p, b = k - a * p;
    const int idx = packed_index<PMAX>(a < b ? a : b, a < b ? b : a);
    float t = 0.f;
    for (int w = 0; w < nw; ++w) t += part[w][idx];
    out[k] = t;
  }
}

// A shard's columns of one gene: column l of the shard is local column l.
//   F: (p, W) rows, float32 or raw int16 (I16, divided by the scales);
//   mask: (W) bytes; X: (p, W) rows of the multiplier scratch.
template <int PMAX, bool I16, bool FULL>
struct ColsSrc {
  const void* F;
  const uint8_t* __restrict__ mask;
  float* X;
  const float* ss;  // PMAX scales, then their reciprocals (shared memory)
  int p, W;

  __device__ __forceinline__ bool on(int l) const {
    return l < W && mask[l] != 0;
  }
  __device__ __forceinline__ float a_at(int l, int i) const {
    if (!DN_ROW(i)) return 0.f;
    const size_t at = (size_t)i * W + l;
    if (I16) return scaled_i16(((const int16_t*)F)[at], ss[i], ss[PMAX + i]);
    return ((const float*)F)[at];
  }
  __device__ __forceinline__ void load_x(int l, float (&x)[PMAX]) const {
#pragma unroll
    for (int i = 0; i < PMAX; ++i)
      x[i] = DN_ROW(i) ? X[(size_t)i * W + l] : 0.f;
  }
  __device__ __forceinline__ void store_x(int l, const float (&x)[PMAX]) const {
#pragma unroll
    for (int i = 0; i < PMAX; ++i)
      if (DN_ROW(i)) X[(size_t)i * W + l] = x[i];
  }
};

// The block's shared state: the warps' packed Gram partials and the scales.
template <int PMAX>
struct ColsSmem {
  static constexpr int NG = PMAX * (PMAX + 1) / 2;
  float part[dn_max_warps<PMAX>()][NG];
  float scale[2 * PMAX];  // scales, then their reciprocals
};

// Scales of the I16 form (ones without `scale`: (float)raw / 1 is exact).
template <int PMAX>
__device__ __forceinline__ void cols_load_scales(ColsSmem<PMAX>& sm,
                                                 const float* scale, int p) {
  if (threadIdx.x < PMAX) {
    const float sv =
        (scale != nullptr && (int)threadIdx.x < p) ? scale[threadIdx.x] : 1.0f;
    sm.scale[threadIdx.x] = sv;
    sm.scale[PMAX + threadIdx.x] = 1.0f / sv;
  }
}

// A whole warp loads row `lane` of the gene's summed p x p Gram.
template <int PMAX>
__device__ __forceinline__ void cols_gram_row(const float* __restrict__ B,
                                              int p, int lane,
                                              float (&row)[PMAX]) {
#pragma unroll
  for (int j = 0; j < PMAX; ++j)
    row[j] = (lane < p && j < p) ? B[lane * p + j] : 0.f;
}

// (a), and kernel 2c's first launch (X == nullptr: no multipliers kept).
template <int PMAX, bool I16, bool FULL>
__global__ void __launch_bounds__(32 * dn_max_warps<PMAX>())
    cols_gram_kernel(const void* __restrict__ F,
                     const uint8_t* __restrict__ mask,
                     const uint8_t* __restrict__ act,
                     const float* __restrict__ scale, float* X,
                     float* __restrict__ gram, int p, int W) {
  __shared__ ColsSmem<PMAX> sm;
  extern __shared__ float tiles[];  // Gram tiles a warp (p >= 16)
  const size_t g = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31,
            warp = tid >> 5;
  float* out = gram + g * p * p;
  if (act != nullptr && act[g] == 0) {
    for (int k = tid; k < p * p; k += nt) out[k] = 0.f;
    return;
  }
  cols_load_scales<PMAX>(sm, scale, p);
  __syncthreads();
  ColsSrc<PMAX, I16, FULL> src;
  src.F = I16 ? (const void*)((const int16_t*)F + g * p * W)
              : (const void*)((const float*)F + g * p * W);
  src.mask = mask + g * W;
  src.X = X != nullptr ? X + g * p * W : nullptr;
  src.ss = sm.scale;
  src.p = p;
  src.W = W;
  WarpGram<PMAX> acc;
  acc.init(tiles + (size_t)warp * warp_work_floats<PMAX>());
  acc.zero();
  for (int l0 = warp * 32; l0 < W; l0 += nt) {
    const int l = l0 + lane;
    const bool on = src.on(l);
    float x[PMAX];
#pragma unroll
    for (int i = 0; i < PMAX; ++i) x[i] = on ? src.a_at(l, i) : 0.f;
    if (on && X != nullptr) src.store_x(l, x);
    acc.add(x, on, lane);
  }
  acc.flush(sm.part[warp], lane);
  __syncthreads();
  cols_block_gram<PMAX>(sm.part, out, p);
}

// (b): power step on the summed Gram B, one merged sweep, next partial Gram.
// u_in == nullptr: the cold start 1 / sqrt(p).  ADAPT: s_in / s_out carry
// s, `done` the frozen genes, `it` is the iteration (0: the cold refit,
// which no freeze test follows).
template <int PMAX, bool I16, bool FULL, bool ADAPT>
__global__ void __launch_bounds__(32 * dn_max_warps<PMAX>())
    cols_sweep_kernel(const void* __restrict__ F,
                      const uint8_t* __restrict__ mask,
                      const uint8_t* __restrict__ act,
                      const float* __restrict__ scale, float* X,
                      const float* __restrict__ B,
                      const float* __restrict__ u_in,
                      float* __restrict__ u_out, float* __restrict__ gram,
                      const float* __restrict__ s_in,
                      float* __restrict__ s_out, uint8_t* done, float tol,
                      int it, int p, int W, int nmf_iter, int n_squared,
                      int n_plain) {
  __shared__ ColsSmem<PMAX> sm;
  extern __shared__ float tiles[];  // a warp's Gram tile and u (p >= 16)
  const size_t g = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31,
            warp = tid >> 5;
  float* out = gram + g * p * p;
  if (act != nullptr && act[g] == 0) {
    for (int k = tid; k < p * p; k += nt) out[k] = 0.f;
    if (tid < p) u_out[g * p + tid] = 0.f;
    if (ADAPT && tid == 0) s_out[g] = 0.f;
    return;
  }
  if constexpr (ADAPT) {
    if (done[g] != 0) {  // frozen: its state carried, nothing added
      for (int k = tid; k < p * p; k += nt) out[k] = 0.f;
      if (tid < p) u_out[g * p + tid] = u_in[g * p + tid];
      if (tid == 0) s_out[g] = s_in[g];
      return;
    }
  }
  cols_load_scales<PMAX>(sm, scale, p);
  // every warp refits u from the same summed Gram: the same bits everywhere
  float u_lane = 0.f, s = 0.f;
  if (lane < p)
    u_lane = u_in != nullptr ? u_in[g * p + lane] : 1.0f / sqrtf((float)p);
  {
    float row[PMAX];
    cols_gram_row<PMAX>(B + g * p * p, p, lane, row);
    const float u_prev = u_lane;
    u_lane = power_refit<PMAX>(row, u_lane, n_squared, n_plain, ADAPT, s);
    if constexpr (ADAPT) {
      if (it > 0) {  // every warp decides on the same bits
        const float k_old = __fmul_rn(u_prev, s_in[g]);
        const float k_new = __fmul_rn(u_lane, s);
        const float delta = warp_max(fabsf(k_new - k_old));
        const float ref = fmaxf(warp_max(fabsf(k_new)), DN_EPS);
        if (delta <= __fmul_rn(tol, ref)) {  // frozen: this refit kept
          for (int k = tid; k < p * p; k += nt) out[k] = 0.f;
          if (warp == 0 && lane < p) u_out[g * p + lane] = u_lane;
          if (tid == 0) {
            s_out[g] = s;
            done[g] = 1;
          }
          return;
        }
      }
    }
  }
  if (warp == 0 && lane < p) u_out[g * p + lane] = u_lane;
  if (ADAPT && tid == 0) s_out[g] = s;
  __syncthreads();
  ColsSrc<PMAX, I16, FULL> src;
  src.F = I16 ? (const void*)((const int16_t*)F + g * p * W)
              : (const void*)((const float*)F + g * p * W);
  src.mask = mask + g * W;
  src.X = X + g * p * W;
  src.ss = sm.scale;
  src.p = p;
  src.W = W;
  const float step =
      nmf_iter > 0 ? (float)(1.0 / sqrt((double)nmf_iter)) : 0.f;
  float* work = tiles + (size_t)warp * warp_work_floats<PMAX>();
  WarpGram<PMAX> acc;
  acc.init(work);
  UVec<PMAX> u;
  u.init(work + PMAX * DN_TILE_STRIDE);
  u.set(u_lane, lane);
  acc.zero();
  for (int l0 = warp * 32; l0 < W; l0 += nt) {
    const int l = l0 + lane;
    const bool on = src.on(l);
    float x[PMAX];
#pragma unroll
    for (int i = 0; i < PMAX; ++i) x[i] = 0.f;
    if (on) {  // a column outside the mask stays exactly zero
      src.load_x(l, x);
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < PMAX; ++i) v = fmaf(x[i], u[i], v);
      // ADAPT: est = K_i E_w taken as u_i (s E_w), as in nmf_core
      const float se = ADAPT ? __fmul_rn(s, v / (s + DN_EPS)) : v;
      // X <- max(X - step * (u_i se - A0), A0), A0 eight rows at a time
#pragma unroll
      for (int i0 = 0; i0 < PMAX; i0 += 8) {
        constexpr int NC = PMAX < 8 ? PMAX : 8;
        float a[NC];
#pragma unroll
        for (int i = 0; i < NC; ++i) a[i] = src.a_at(l, i0 + i);
#pragma unroll
        for (int i = 0; i < NC; ++i)
          x[i0 + i] = fmaxf(x[i0 + i] - step * (u[i0 + i] * se - a[i]), a[i]);
      }
      src.store_x(l, x);
    }
    acc.add(x, on, lane);
  }
  acc.flush(sm.part[warp], lane);
  __syncthreads();
  cols_block_gram<PMAX>(sm.part, out, p);
}

// (c): u and s from the summed Gram B, K = u s, E = X^T u / (s + eps) on the
// shard's columns (zero outside the mask).  ADAPT: a frozen gene's u and s
// (u_in, s_in) as they are.
template <int PMAX, bool FULL, bool ADAPT>
__global__ void __launch_bounds__(32 * dn_max_warps<PMAX>())
    cols_finish_kernel(const uint8_t* __restrict__ mask,
                       const uint8_t* __restrict__ act,
                       const float* __restrict__ X,
                       const float* __restrict__ B,
                       const float* __restrict__ u_in, float* __restrict__ K,
                       float* __restrict__ E, float* __restrict__ u_out,
                       const float* __restrict__ s_in,
                       const uint8_t* __restrict__ done, int p, int W,
                       int n_squared, int n_plain) {
  extern __shared__ float tiles[];  // a warp's u (p >= 16)
  const size_t g = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31,
            warp = tid >> 5;
  float* Eg = E + g * W;
  if (act != nullptr && act[g] == 0) {
    for (int l = tid; l < W; l += nt) Eg[l] = 0.f;
    if (tid < p) {
      K[g * p + tid] = 0.f;
      u_out[g * p + tid] = 0.f;
    }
    return;
  }
  float u_lane = 0.f, s = 0.f;
  if (lane < p)
    u_lane = u_in != nullptr ? u_in[g * p + lane] : 1.0f / sqrtf((float)p);
  if (ADAPT && done[g] != 0) {
    s = s_in[g];
  } else {
    float row[PMAX];
    cols_gram_row<PMAX>(B + g * p * p, p, lane, row);
    u_lane = power_refit<PMAX>(row, u_lane, n_squared, n_plain, true, s);
  }
  if (warp == 0 && lane < p) {
    K[g * p + lane] = u_lane * s;
    u_out[g * p + lane] = u_lane;
  }
  UVec<PMAX> u;
  u.init(tiles + (size_t)warp * warp_work_floats<PMAX>() +
         PMAX * DN_TILE_STRIDE);
  u.set(u_lane, lane);
  const uint8_t* mg = mask + g * W;
  const float* Xg = X + g * p * W;
  for (int l0 = warp * 32; l0 < W; l0 += nt) {
    const int l = l0 + lane;
    if (l >= W) continue;
    float e = 0.f;
    if (mg[l] != 0) {
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < PMAX; ++i)
        if (DN_ROW(i)) v = fmaf(Xg[(size_t)i * W + l], u[i], v);
      e = v / (s + DN_EPS);
    }
    Eg[l] = e;
  }
}

// Dynamic shared memory of a block: the warps' Gram tiles and u (p >= 16).
template <int PMAX>
static size_t cols_dyn_bytes(int threads) {
  return sizeof(float) * gram_tile_floats<PMAX>(threads / 32);
}

template <class Kernel>
static cudaError_t cols_prepare(Kernel kernel, size_t dyn) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
}

// The arguments of the three launches, handed from the C entry points
// (stream_cols.cu) to the translation unit of the input form.
struct ColsArgs {
  const void* F;  // int16 or float32 (not read by the finishing launch)
  const uint8_t* mask;
  const uint8_t* act;
  const float* scale;
  float* X;
  const float* B;
  const float* u_in;
  float* u_out;
  float* gram;
  float* K;
  float* E;
  const float* s_in;  // ADAPT: s carried from launch to launch
  float* s_out;
  uint8_t* done;      // ADAPT: the frozen genes
  float tol;
  int it;
  int G, p, W, nmf_iter, n_squared, n_plain, threads;
  cudaStream_t st;
};

template <int PM, bool I16, bool FULL, bool ADAPT>
static int cols_launch(int which, const ColsArgs& a) {
  if (a.threads > 32 * dn_max_warps<PM>()) return (int)cudaErrorInvalidValue;
  const size_t dyn = cols_dyn_bytes<PM>(a.threads);
  const dim3 grid((unsigned)a.G), block((unsigned)a.threads);
  cudaError_t e;
  if (which == 0) {
    if constexpr (ADAPT) {
      return (int)cudaErrorInvalidValue;  // (a) has one instance, not ADAPT
    } else {
      e = cols_prepare(cols_gram_kernel<PM, I16, FULL>, dyn);
      if (e != cudaSuccess) return (int)e;
      cols_gram_kernel<PM, I16, FULL><<<grid, block, dyn, a.st>>>(
          a.F, a.mask, a.act, a.scale, a.X, a.gram, a.p, a.W);
    }
  } else if (which == 1) {
    e = cols_prepare(cols_sweep_kernel<PM, I16, FULL, ADAPT>, dyn);
    if (e != cudaSuccess) return (int)e;
    cols_sweep_kernel<PM, I16, FULL, ADAPT><<<grid, block, dyn, a.st>>>(
        a.F, a.mask, a.act, a.scale, a.X, a.B, a.u_in, a.u_out, a.gram,
        a.s_in, a.s_out, a.done, a.tol, a.it, a.p, a.W, a.nmf_iter,
        a.n_squared, a.n_plain);
  } else if constexpr (I16) {
    return (int)cudaErrorInvalidValue;  // the finish reads no input: f32 TU
  } else {
    e = cols_prepare(cols_finish_kernel<PM, FULL, ADAPT>, dyn);
    if (e != cudaSuccess) return (int)e;
    cols_finish_kernel<PM, FULL, ADAPT><<<grid, block, dyn, a.st>>>(
        a.mask, a.act, a.X, a.B, a.u_in, a.K, a.E, a.u_out, a.s_in, a.done,
        a.p, a.W, a.n_squared, a.n_plain);
  }
  return (int)cudaGetLastError();
}

// One translation unit an input form: stream_cols_<f32|i16>.cu, and the
// ADAPT instances of both in stream_cols_tol.cu.
template <bool I16, bool ADAPT>
static int cols_launch_form(int which, const ColsArgs& a) {
#define DN_COLS_CALL(PM, FULLV) \
  return cols_launch<PM, I16, FULLV, ADAPT>(which, a)
  DN_DISPATCH_P(a.p, DN_COLS_CALL);
#undef DN_COLS_CALL
  return (int)cudaErrorInvalidValue;  // not reached
}

int dn_cols_f32(int which, const ColsArgs& a);
int dn_cols_i16(int which, const ColsArgs& a);
int dn_cols_tol(int f_is_i16, int which, const ColsArgs& a);
