// Kernels 4c and 2c for 33 <= p <= 128 samples: the NMF-OA loop and the
// ratio-SVD row sums of a COLUMN-SHARDED gene bucket, cut at their
// reductions as stream_cols.cuh cuts them at p <= 32, each block's columns
// on wide.cuh's block-level SYRK layout.  The C entry points stay
// stream_cols.cu's and ratio_cols.cu's, which hand p > 32 here; the
// instances are compiled in stream_cols_wide_<f32|i16|tol>.cu and
// ratio_cols_wide.cu, side by side.
//
// Replaces no Pallas kernel: on a mesh the JAX package runs a
// column-sharded bucket on its XLA path at any number of samples
// (degnorm_tpu/engine.py:75-84, :409-426), with GSPMD's all-reduce at each
// reduction point.  The launches and what they compute are stream_cols.cuh's
// ((a) X = A0 and the partial Gram of A0 over the shard; (b) once an
// iteration the S shards' partials summed, the power step, one merged sweep
// and the next partial; (c) the last sum, u, s, K and E; kernel 2c's second
// launch the cold power step and the row sums of A0 and of max(K e, A0)),
// with wide.cuh's arithmetic for each step:
//   * the p <= 32 layout cannot be widened: it holds a column's x[PMAX] in
//     registers and keeps per-warp partials of PMAX (PMAX + 1) / 2 floats,
//     neither of which survives PMAX = 128.  Here a block of 256 threads
//     stages its columns in tiles of 64 through shared memory
//     (wide_sweep_sync: thread (q, c) rows q Q .. q Q + Q - 1 of column c,
//     v's quarters summed in a fixed order, the update in place) and adds
//     each tile to its register tile of the full Gram (WideGram: R x R
//     entries a thread); the block's Gram goes to B in shared memory;
//   * a gene's columns of the shard are dealt to `nb` blocks in chunks of
//     DN_STREAM_CHUNK (two tiles), as at p <= 32; the blocks' partials (the
//     upper triangle, packed) meet in block order through the gene's
//     integer ticket (cols_gene_store), and the shards' in shard order
//     inside the next launch, summed into B with plain float32 adds: the
//     bits of ColumnGroup.combine's sum (Columns.gather_).  No float
//     atomics;
//   * every block of every shard runs the power step on the same summed B
//     (wide_refit: B^2 as a register tile, the matvecs reduced by a fixed
//     butterfly, every norm summed by each thread in one order), so u and
//     s are bit-equal everywhere with no broadcast; under ADAPT the freeze
//     test is wide_core's on those bits;
//   * kernel 2c's row sums: thread (q, c) keeps its rows' sums of A0 and of
//     max(K e, A0) over its column of each tile (e = v / (s + eps), v's
//     quarters summed in a fixed order), then the block's 64 columns are
//     summed a row in column order, then the blocks' in block order, then
//     the shards': a few hundred adds a value, as at p <= 32 (a row summed
//     over all of a block's columns in one chain drifted 1.1e-5 from the
//     plain version at 64 x 33 x 65,536).
// What bounds it on this card: float32 operations, the Gram's p^2 fmas a
// column a sweep (the full register tile: both triangles), against X read
// and written and A0 read once a sweep through device memory (8 + 2 or 4
// bytes an element), the price of a launch a sweep.  Shared memory: the
// synchronous core's (wide_sync_floats: 138,880 bytes at PMAX = 128), one
// block an SM there, two at PMAX <= 64.
#pragma once

#include "stream_cols.cuh"
#include "wide.cuh"

// Index of the Gram's entry (i, j), i <= j, in a gene's packed partial.
template <int PMAX>
__device__ __forceinline__ int wcols_tri(int i, int j) {
  return i * PMAX - i * (i - 1) / 2 + (j - i);
}

// One block's columns of a gene on the shard (wide.cuh's Src, runtime
// rows): local slot l is column ((l / CH) * nb + rank) * CH + l % CH.
template <int PMAX, bool I16>
struct WColsSrc {
  using AType = typename std::conditional<I16, int16_t, float>::type;
  static constexpr bool PIPE = false;  // wide_sweep_sync
  const void* F;    // the gene's (p, W) rows, float32 or int16
  const uint8_t* __restrict__ mask;
  float* X;         // the gene's (p, W) rows of the scratch, or null (2c)
  float* E;
  const float* ss;  // the scales (I16) and their reciprocals (shared)
  int W, rank, nb, nloc;

  // this block's chunks of the first nch: rank, rank + nb, ...
  __device__ __forceinline__ void deal(int nch) {
    nloc = (rank < nch ? (nch - rank + nb - 1) / nb : 0) * DN_STREAM_CHUNK;
  }
  __device__ __forceinline__ int col(int l) const {
    return ((l / DN_STREAM_CHUNK) * nb + rank) * DN_STREAM_CHUNK +
           (l % DN_STREAM_CHUNK);
  }
  __device__ __forceinline__ int n_local() const { return nloc; }
  __device__ __forceinline__ bool on(int l) const {
    if (l >= nloc) return false;
    const int w = col(l);
    return w < W && mask[w] != 0;
  }
  // kernel 4c's A0: float32, or raw int16 over its scale (scaled_i16)
  __device__ __forceinline__ float a0(int l, int i) const {
    const size_t at = (size_t)i * W + col(l);
    if constexpr (I16)
      return scaled_i16(((const int16_t*)F)[at], ss[i], ss[PMAX + i]);
    else
      return ((const float*)F)[at];
  }
  // kernel 2c's A0: the coverage as stored
  __device__ __forceinline__ float raw(int l, int i) const {
    const size_t at = (size_t)i * W + col(l);
    if constexpr (I16) return (float)((const int16_t*)F)[at];
    else return ((const float*)F)[at];
  }
  __device__ __forceinline__ float x(int l, int i) const {
    return X[(size_t)i * W + col(l)];
  }
  __device__ __forceinline__ void set_x(int l, int i, float v) const {
    if (X != nullptr) X[(size_t)i * W + col(l)] = v;
  }
  __device__ __forceinline__ void store_e(int l, float e) const {
    if (l >= nloc) return;
    const int w = col(l);
    if (w < W) E[w] = e;
  }
};

// The block's Gram in w.B (visible) packed into `pk` (the upper triangle,
// NG floats, shared memory), then the gene's partial over its `nact`
// blocks into `out` (cols_gene_store).  Whole block.
template <int PMAX>
__device__ __forceinline__ void wcols_store(const WideWork<PMAX>& w,
                                            float* pk, float* out,
                                            float* bpart, int* ticket,
                                            int rank, int nact) {
  constexpr int LD = WideShape<PMAX>::LD, NG = cols_ng<PMAX>();
  for (int e = threadIdx.x; e < PMAX * PMAX; e += blockDim.x) {
    const int i = e / PMAX, j = e % PMAX;
    if (j >= i) pk[wcols_tri<PMAX>(i, j)] = w.B[i * LD + j];
  }
  __syncthreads();
  cols_gene_store(pk, NG, out, bpart, ticket, rank, nact);
}

// The gene's Gram from the S shards' packed partials (`parts`: S slices
// `stride` floats apart, at this gene's) into w.B with its mirror, summed
// in shard order with plain float32 adds (cols_sum_shards' bits).  Whole
// block; the caller's barrier makes B visible.
template <int PMAX>
__device__ __forceinline__ void wcols_sum_shards(const float* __restrict__ parts,
                                                 size_t stride, int S,
                                                 WideWork<PMAX>& w) {
  constexpr int LD = WideShape<PMAX>::LD;
  for (int e = threadIdx.x; e < PMAX * PMAX; e += blockDim.x) {
    const int i = e / PMAX, j = e % PMAX;
    if (j < i) continue;
    const int k = wcols_tri<PMAX>(i, j);
    float t = parts[k];
    for (int s = 1; s < S; ++s) t = __fadd_rn(t, parts[s * stride + k]);
    w.B[i * LD + j] = t;
    w.B[j * LD + i] = t;
  }
}

// The scales of kernel 4c's int16 form into ss (ones without `scale`), the
// left vector into w.u: u_in's row of the gene, or the cold 1 / sqrt(p),
// zero beyond p.  The caller's barrier makes them visible.
template <int PMAX>
__device__ __forceinline__ void wcols_setup(float* ss, const float* scale,
                                            WideWork<PMAX>& w,
                                            const float* u_in, size_t g,
                                            int p) {
  const int t = threadIdx.x;
  if (t < PMAX) {
    const float sv = (scale != nullptr && t < p) ? scale[t] : 1.0f;
    ss[t] = sv;
    ss[PMAX + t] = 1.0f / sv;
    w.u[t] = t < p ? (u_in != nullptr ? u_in[g * p + t]
                                      : 1.0f / sqrtf((float)p))
                   : 0.f;
  }
}

// The tile threads' mask bits of a merged sweep (wide_sweep_sync's `bits`,
// which a cold sweep of the same launch would have set): slot k is this
// thread's column of tile k.
template <class Src>
__device__ __forceinline__ unsigned long long wcols_bits(const Src& src) {
  unsigned long long bits = 0ull;
  const int c = threadIdx.x & (DN_WIDE_TC - 1);
  const int ntile = (src.n_local() + DN_WIDE_TC - 1) / DN_WIDE_TC;
  for (int k = 0; k < ntile && k < 64; ++k)
    if (src.on(k * DN_WIDE_TC + c)) bits |= 1ull << k;
  return bits;
}

template <int PMAX, bool I16>
__device__ __forceinline__ WColsSrc<PMAX, I16> wcols_src(
    const void* F, const uint8_t* mask, float* X, float* E, const float* ss,
    size_t g, int p, int W, int rank, int nb, int nch) {
  WColsSrc<PMAX, I16> src;
  src.F = F == nullptr ? nullptr
          : I16        ? (const void*)((const int16_t*)F + g * p * W)
                       : (const void*)((const float*)F + g * p * W);
  src.mask = mask + g * W;
  src.X = X != nullptr ? X + g * p * W : nullptr;
  src.E = E != nullptr ? E + g * W : nullptr;
  src.ss = ss;
  src.W = W;
  src.rank = rank;
  src.nb = nb;
  src.deal(nch);
  return src;
}

// (a), and kernel 2c's first launch (X == nullptr): the cold sweep (X = A0)
// of every chunk the block is dealt of the whole shard and its Gram;
// `ncols` (zeroed by the caller) receives the gene's last active column + 1.
template <int PMAX, bool I16>
__global__ void __launch_bounds__(DN_WIDE_THREADS, 1)
    wcols_gram_kernel(const void* __restrict__ F,
                      const uint8_t* __restrict__ mask,
                      const uint8_t* __restrict__ act,
                      const float* __restrict__ scale, float* X,
                      float* __restrict__ gram, float* bpart, int* tickets,
                      int* ncols, int p, int W, int nb) {
  constexpr int NG = cols_ng<PMAX>();
  __shared__ float ss[2 * PMAX];
  extern __shared__ float4 dyn4[];
  WideWork<PMAX> w;
  w.init((float*)dyn4);
  const ColsBlock b(nb);
  const size_t g = b.g;
  const int tid = threadIdx.x, lane = tid & 31;
  float* out = gram + g * NG;
  if (act != nullptr && act[g] == 0) {
    if (b.rank == 0)
      for (int k = tid; k < NG; k += blockDim.x) out[k] = 0.f;
    return;
  }
  wcols_setup<PMAX>(ss, scale, w, nullptr, g, p);
  __syncthreads();
  const auto src = wcols_src<PMAX, I16>(F, mask, X, nullptr, ss, g, p, W,
                                        b.rank, nb,
                                        (W + DN_STREAM_CHUNK - 1) /
                                            DN_STREAM_CHUNK);
  int last = 0;
  for (int l = tid; l < src.nloc; l += blockDim.x)
    if (src.on(l)) last = max(last, src.col(l) + 1);
  // an integer max: the same whatever the order
  last = __reduce_max_sync(DN_FULL, last);
  if (lane == 0 && last > 0) atomicMax(ncols + g, last);
  WideGram<PMAX> gr;
  unsigned long long bits = 0ull;
  wide_sweep_sync<PMAX, false, false>(src, WideBlockRed{}, w, gr, p, 0.f,
                                      0.f, false, bits);
  wcols_store<PMAX>(w, w.S1, out, bpart + g * nb * NG, tickets + g, b.rank,
                    nb);
}

// (b): the power step on the summed partials `parts` (S shards), one merged
// sweep, the next partial Gram.  u_in == nullptr: the cold start.  ADAPT:
// s_in / s_out carry s, `done` the frozen genes, `it` the iteration (0:
// the cold refit, which no freeze test follows).
template <int PMAX, bool I16, bool ADAPT>
__global__ void __launch_bounds__(DN_WIDE_THREADS, 1)
    wcols_sweep_kernel(const void* __restrict__ F,
                       const uint8_t* __restrict__ mask,
                       const uint8_t* __restrict__ act,
                       const float* __restrict__ scale, float* X,
                       const float* __restrict__ parts, int S,
                       const int* __restrict__ ncols,
                       const float* __restrict__ u_in,
                       float* __restrict__ u_out, float* __restrict__ gram,
                       float* bpart, int* tickets,
                       const float* __restrict__ s_in,
                       float* __restrict__ s_out, uint8_t* done, float tol,
                       int it, int G, int p, int W, int nmf_iter,
                       int n_squared, int n_plain, int nb) {
  constexpr int NG = cols_ng<PMAX>();
  __shared__ float ss[2 * PMAX];
  extern __shared__ float4 dyn4[];
  WideWork<PMAX> w;
  w.init((float*)dyn4);
  const ColsBlock b(nb);
  const size_t g = b.g;
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool lead = b.rank == 0;  // writes the gene's u, s and flags
  float* out = gram + g * NG;
  if (act != nullptr && act[g] == 0) {
    if (lead) {
      for (int k = tid; k < NG; k += nt) out[k] = 0.f;
      if (tid < p) u_out[g * p + tid] = 0.f;
      if (ADAPT && tid == 0) s_out[g] = 0.f;
    }
    return;
  }
  const int nact = cols_active_blocks(ncols[g], nb);
  if (b.rank >= nact) return;
  if constexpr (ADAPT) {
    if (done[g] != 0) {  // frozen: its state carried, nothing added
      if (lead) {
        for (int k = tid; k < NG; k += nt) out[k] = 0.f;
        if (tid < p) u_out[g * p + tid] = u_in[g * p + tid];
        if (tid == 0) s_out[g] = s_in[g];
      }
      return;
    }
  }
  wcols_setup<PMAX>(ss, scale, w, u_in, g, p);
  wcols_sum_shards<PMAX>(parts + g * NG, (size_t)G * NG, S, w);
  if (ADAPT && tid < PMAX) w.uo[tid] = w.u[tid];
  __syncthreads();
  // every block refits u from the same summed Gram: the same bits
  // everywhere
  WideGram<PMAX> gr;
  float s = 0.f;
  wide_refit<PMAX>(w, gr, n_squared, n_plain, ADAPT, s);
  if constexpr (ADAPT) {
    if (it > 0) {  // every block of every shard decides on the same bits
      const float s_old = s_in[g];
      float delta = 0.f, ref = 0.f;
#pragma unroll 8
      for (int j = 0; j < PMAX; ++j) {
        const float k_new = __fmul_rn(w.u[j], s);
        delta = fmaxf(delta, fabsf(k_new - __fmul_rn(w.uo[j], s_old)));
        ref = fmaxf(ref, fabsf(k_new));
      }
      ref = fmaxf(ref, DN_EPS);
      if (delta <= __fmul_rn(tol, ref)) {  // frozen: this refit kept
        if (lead) {
          for (int k = tid; k < NG; k += nt) out[k] = 0.f;
          if (tid < p) u_out[g * p + tid] = w.u[tid];
          if (tid == 0) {
            s_out[g] = s;
            done[g] = 1;
          }
        }
        return;
      }
    }
  }
  if (lead && tid < p) u_out[g * p + tid] = w.u[tid];
  if (ADAPT && lead && tid == 0) s_out[g] = s;
  const auto src = wcols_src<PMAX, I16>(F, mask, X, nullptr, ss, g, p, W,
                                        b.rank, nb,
                                        (ncols[g] + DN_STREAM_CHUNK - 1) /
                                            DN_STREAM_CHUNK);
  const float step =
      nmf_iter > 0 ? (float)(1.0 / sqrt((double)nmf_iter)) : 0.f;
  unsigned long long bits = wcols_bits(src);
  wide_sweep_sync<PMAX, ADAPT, true>(src, WideBlockRed{}, w, gr, p, step, s,
                                     false, bits);
  wcols_store<PMAX>(w, w.S1, out, bpart + g * nb * NG, tickets + g, b.rank,
                    nact);
}

// (c): u and s from the summed partials `parts` (S shards), K = u s, E =
// X^T u / (s + eps) on the shard's columns (zero outside the mask), as
// wide_core's finish.  ADAPT: a frozen gene's u and s (u_in, s_in) as
// they are.
template <int PMAX, bool ADAPT>
__global__ void __launch_bounds__(DN_WIDE_THREADS, 1)
    wcols_finish_kernel(const uint8_t* __restrict__ mask,
                        const uint8_t* __restrict__ act,
                        const float* __restrict__ X,
                        const float* __restrict__ parts, int S,
                        const int* __restrict__ ncols,
                        const float* __restrict__ u_in, float* __restrict__ K,
                        float* __restrict__ E, float* __restrict__ u_out,
                        const float* __restrict__ s_in,
                        const uint8_t* __restrict__ done, int G, int p, int W,
                        int n_squared, int n_plain, int nb) {
  constexpr int NG = cols_ng<PMAX>(), Q = WideShape<PMAX>::Q;
  constexpr int TC = DN_WIDE_TC, CH = DN_STREAM_CHUNK;
  __shared__ float ss[2 * PMAX];
  extern __shared__ float4 dyn4[];
  WideWork<PMAX> w;
  w.init((float*)dyn4);
  const ColsBlock b(nb);
  const size_t g = b.g;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int q = tid >> 6, c = tid & (TC - 1), i0 = q * Q;
  const bool lead = b.rank == 0;
  float* Eg = E + g * W;
  const bool live = act == nullptr || act[g] != 0;
  const int nact = live ? cols_active_blocks(ncols[g], nb) : 1;
  if (b.rank >= nact) return;
  if (!live) {
    for (int l = tid; l < W; l += nt) Eg[l] = 0.f;
    if (tid < p) {
      K[g * p + tid] = 0.f;
      u_out[g * p + tid] = 0.f;
    }
    return;
  }
  wcols_setup<PMAX>(ss, nullptr, w, u_in, g, p);
  float s = 0.f;
  if (ADAPT && done[g] != 0) {
    s = s_in[g];
    __syncthreads();
  } else {
    wcols_sum_shards<PMAX>(parts + g * NG, (size_t)G * NG, S, w);
    __syncthreads();
    WideGram<PMAX> gr;
    wide_refit<PMAX>(w, gr, n_squared, n_plain, true, s);
  }
  if (lead && tid < p) {
    K[g * p + tid] = w.u[tid] * s;
    u_out[g * p + tid] = w.u[tid];
  }
  const int nch = (ncols[g] + CH - 1) / CH;
  const auto src = wcols_src<PMAX, false>(nullptr, mask, (float*)X, E, ss, g,
                                          p, W, b.rank, nb, nch);
  for (int l0 = 0; l0 < src.nloc; l0 += TC) {
    const int l = l0 + c;
    const bool on = src.on(l);
    float vp = 0.f;
    if (on) {
#pragma unroll 4
      for (int kk = 0; kk < Q; ++kk) {
        const int i = i0 + kk;
        if (i < p) vp = fmaf(src.x(l, i), w.u[i], vp);
      }
    }
    w.vpart[q * TC + c] = vp;
    __syncthreads();
    if (q == 0) {
      float e = 0.f;
      if (on) {
        const float v = ((w.vpart[c] + w.vpart[TC + c]) + w.vpart[2 * TC + c]) +
                        w.vpart[3 * TC + c];
        e = v / (s + DN_EPS);
      }
      src.store_e(l, e);
    }
    __syncthreads();
  }
  // E past the dealt chunks
  for (int l = nch * CH + b.rank * nt + tid; l < W; l += nact * nt)
    Eg[l] = 0.f;
}

// Kernel 2c's second launch: every shard's partial of the first summed, the
// cold power step on it from 1 / sqrt(p), s, K = u s; then thread (q, c)
// reads rows q Q .. q Q + Q - 1 of its column of each tile of A0 (the
// coverage as stored, zeros off the mask) into registers, e = v / (s +
// eps) of the column, and adds the rows to its sums of A0 and of max(K e,
// A0); the block's 64 columns' sums are added a row in column order, and
// the blocks' meet in block order (cols_gene_store) into sums (G, 2p).
template <int PMAX, bool I16>
__global__ void __launch_bounds__(DN_WIDE_THREADS, 1)
    wratio_cols_sums_kernel(const void* __restrict__ F,
                            const uint8_t* __restrict__ mask,
                            const float* __restrict__ parts, int S,
                            const int* __restrict__ ncols,
                            float* __restrict__ sums, float* bpart,
                            int* tickets, int G, int p, int W, int power_cold,
                            int nb) {
  constexpr int NG = cols_ng<PMAX>(), Q = WideShape<PMAX>::Q;
  constexpr int LD = WideShape<PMAX>::LD, TC = DN_WIDE_TC;
  __shared__ float ss[2 * PMAX];
  extern __shared__ float4 dyn4[];
  WideWork<PMAX> w;
  w.init((float*)dyn4);
  const ColsBlock b(nb);
  const size_t g = b.g;
  const int tid = threadIdx.x;
  const int q = tid >> 6, c = tid & (TC - 1), i0 = q * Q;
  const int nch = (ncols[g] + DN_STREAM_CHUNK - 1) / DN_STREAM_CHUNK;
  const int nact = cols_active_blocks(ncols[g], nb);
  if (b.rank >= nact) return;
  wcols_setup<PMAX>(ss, nullptr, w, nullptr, g, p);
  wcols_sum_shards<PMAX>(parts + g * NG, (size_t)G * NG, S, w);
  __syncthreads();
  WideGram<PMAX> gr;
  float s = 0.f;
  wide_refit<PMAX>(w, gr, power_cold, 0, true, s);
  if (tid < PMAX) w.uo[tid] = w.u[tid] * s;  // K (zero beyond p)
  __syncthreads();
  const float den = s + DN_EPS;
  const auto src = wcols_src<PMAX, I16>(F, mask, nullptr, nullptr, ss, g, p,
                                        W, b.rank, nb, nch);
  float rs[Q], es[Q];  // this thread's rows i0 .. i0 + Q - 1
#pragma unroll
  for (int k = 0; k < Q; ++k) rs[k] = es[k] = 0.f;
  for (int l0 = 0; l0 < src.nloc; l0 += TC) {
    const int l = l0 + c;
    const bool on = src.on(l);
    float x[Q], vp = 0.f;
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const int i = i0 + k;
      x[k] = (on && i < p) ? src.raw(l, i) : 0.f;
      vp = fmaf(x[k], w.u[i], vp);
    }
    w.vpart[q * TC + c] = vp;
    // a tile with no active column adds nothing
    if (!__syncthreads_or(on)) continue;
    if (on) {
      const float e = (((w.vpart[c] + w.vpart[TC + c]) + w.vpart[2 * TC + c]) +
                       w.vpart[3 * TC + c]) / den;
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        rs[k] += x[k];
        es[k] += fmaxf(w.uo[i0 + k] * e, x[k]);
      }
    }
    __syncthreads();  // vpart is read before the next tile writes it
  }
  // the block's columns' sums, a row in column order
  wide_st<Q>(w.S + c * LD + i0, rs);
  wide_st<Q>(w.S1 + c * LD + i0, es);
  __syncthreads();
  float rsum = 0.f, esum = 0.f;
  if (tid < p)
    for (int k = 0; k < TC; ++k) {
      rsum += w.S[k * LD + tid];
      esum += w.S1[k * LD + tid];
    }
  __syncthreads();  // S1 is read before the sums go in
  float* blk = w.S1;
  if (tid < p) {
    blk[tid] = rsum;
    blk[p + tid] = esum;
  }
  __syncthreads();
  cols_gene_store(blk, 2 * p, sums + g * 2 * p, bpart + g * nb * 2 * p,
                  tickets + g, b.rank, nact);
}

// Dynamic shared memory of a block: the synchronous core's.
template <int PMAX>
static size_t wcols_dyn_bytes() {
  return sizeof(float) * wide_sync_floats<PMAX>();
}

template <int PM, bool I16, bool ADAPT>
static int wcols_launch(int which, const ColsArgs& a) {
  if (a.threads != DN_WIDE_THREADS) return (int)cudaErrorInvalidValue;
  const size_t dyn = wcols_dyn_bytes<PM>();
  const dim3 grid((unsigned)((size_t)a.G * a.nb)), block(DN_WIDE_THREADS);
  cudaError_t e;
  if (which == 0) {
    if constexpr (ADAPT) {
      return (int)cudaErrorInvalidValue;  // (a) has one instance, not ADAPT
    } else {
      e = cols_prepare(wcols_gram_kernel<PM, I16>, dyn);
      if (e != cudaSuccess) return (int)e;
      wcols_gram_kernel<PM, I16><<<grid, block, dyn, a.st>>>(
          a.F, a.mask, a.act, a.scale, a.X, a.gram, a.bpart, a.tickets,
          a.ncols, a.p, a.W, a.nb);
    }
  } else if (which == 1) {
    e = cols_prepare(wcols_sweep_kernel<PM, I16, ADAPT>, dyn);
    if (e != cudaSuccess) return (int)e;
    wcols_sweep_kernel<PM, I16, ADAPT><<<grid, block, dyn, a.st>>>(
        a.F, a.mask, a.act, a.scale, a.X, a.parts, a.S, a.ncols, a.u_in,
        a.u_out, a.gram, a.bpart, a.tickets, a.s_in, a.s_out, a.done, a.tol,
        a.it, a.G, a.p, a.W, a.nmf_iter, a.n_squared, a.n_plain, a.nb);
  } else if constexpr (I16) {
    return (int)cudaErrorInvalidValue;  // the finish reads no input: f32 TU
  } else {
    e = cols_prepare(wcols_finish_kernel<PM, ADAPT>, dyn);
    if (e != cudaSuccess) return (int)e;
    wcols_finish_kernel<PM, ADAPT><<<grid, block, dyn, a.st>>>(
        a.mask, a.act, a.X, a.parts, a.S, a.ncols, a.u_in, a.K, a.E, a.u_out,
        a.s_in, a.done, a.G, a.p, a.W, a.n_squared, a.n_plain, a.nb);
  }
  return (int)cudaGetLastError();
}

// One translation unit an input form: stream_cols_wide_<f32|i16>.cu, and
// the ADAPT instances of both in stream_cols_wide_tol.cu.
template <bool I16, bool ADAPT>
static int wcols_launch_form(int which, const ColsArgs& a) {
#define DN_WCOLS_CALL(PM) return wcols_launch<PM, I16, ADAPT>(which, a)
  DN_DISPATCH_WIDE_P(a.p, DN_WCOLS_CALL);
#undef DN_WCOLS_CALL
  return (int)cudaErrorInvalidValue;  // not reached
}

int dn_wcols_f32(int which, const ColsArgs& a);
int dn_wcols_i16(int which, const ColsArgs& a);
int dn_wcols_tol(int f_is_i16, int which, const ColsArgs& a);
int dn_wratio_cols(const void* F, int f_is_i16, const uint8_t* mask,
                   const float* parts, int S, const int* ncols, float* sums,
                   float* bpart, int* tickets, int G, int p, int W,
                   int power_cold, int nb, cudaStream_t st);
