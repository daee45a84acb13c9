// Kernel 4c: the NMF-OA loop of a COLUMN-SHARDED gene bucket, cut at its
// reductions, a gene's columns of the shard spread over `nb` thread blocks.
// Kernel 2c (ratio_cols.cu) shares its Gram launch and its reductions.
// These are the instances for p <= 32; at 33 <= p <= 128 the wide ones of
// stream_cols_wide.cuh run the same launches on wide.cuh's layout.
//
// Replaces no Pallas kernel: on a mesh the JAX package runs such a bucket
// on its XLA path (degnorm_tpu/engine.py:75-84, _seqpar_safe), and GSPMD
// places one all-reduce at each reduction point (parallel/seqpar.py:1-26).
// Kernel 4 (stream.cuh) reduces the p x p Gram of each sweep across a
// gene's columns inside one cluster; a shard holds only some of them, so
// the loop is cut where the Gram is summed, one launch a sweep:
//   (a) cols_gram_kernel: X = A0 = F * mask (A0 of kernel 4's input forms:
//       float32, or raw int16 divided by `scale` exactly as stream.cuh's
//       scaled_i16 does), the gene's partial Gram of A0 over the shard and
//       the gene's last active column on the shard (`ncols`);
//   (b) cols_sweep_kernel, once an iteration: the S shards' partial Grams
//       of the last launch summed, u refit by the power step on that sum
//       (every warp of every block of every shard runs the same step on the
//       same bits, so u is bit-equal everywhere with no broadcast), one
//       merged sweep X <- max(X - step (u (u^T X) - A0), A0) over the
//       shard's columns, and the partial Gram of the new X;
//   (c) cols_finish_kernel: the last partials summed, u and s refit, K = u
//       s, E = X^T u / (s + eps) on the shard's columns.
// The arithmetic of each step is common.cuh's (nmf_core's sweep,
// power_refit), in the same order.  ADAPT (EngineConfig.nmf_tol > 0, which
// the JAX package's XLA path honours at any width): nmf_core's adaptive
// branch cut the same way: (b) refits u and s, freezes a gene after the
// first refit with max|K_new - K_old| <= tol max(max|K|, 1e-30) (that
// refit kept, `done` set, its partials zero from then on) and sweeps with
// est = u_i s (v / (s + eps)); (c) takes a frozen gene's u and s as they
// are.
//
// What bounds it on this card.  On a bucket of many genes (the long tail's
// 384 slots), bytes: a sweep reads and writes X in device memory (8 bytes
// an element) and reads A0 again (2 or 4), where kernel 4 keeps both in
// shared memory for the whole loop, since X of a shard (400 MB for the
// long tail) fits in no on-chip memory between launches.  On a bucket of
// one to three outlier genes (TTN alone is over 100,000 bases), latency:
// a sweep is a few MB, most of it in the L2 cache, and a gene's columns
// must be spread over the card to be swept in a few microseconds.  The
// design:
//   * A gene's columns of the shard go to `nb` blocks (chosen by shape in
//     ops/cuda_stream.py::pick_cols_geometry: one where the bucket's genes
//     fill the card, enough to fill the SMs for one to three genes), dealt
//     in chunks of DN_STREAM_CHUNK round robin as stream.cuh deals them.
//     Launch (a) walks every chunk and finds the gene's last active column
//     (an integer max); the later launches deal only the chunks up to it,
//     and a block past them leaves at once, so padding costs nothing.
//   * The blocks' partials meet in a fixed order: a block's warps' partials
//     are summed in warp order; with one block the sum is the gene's
//     partial; with more, each block writes its partial to device memory
//     and the last block to arrive (an integer ticket a gene, reset by
//     that block for the next launch) sums them in block order.  No float
//     atomics: two runs with one geometry give the same bits.  (No cluster
//     level: a cluster's shared-memory sum would cut the last block's
//     reads by the cluster's size at the price of a cluster barrier a
//     launch, and the reads are p(p+1)/2 floats a block.)
//   * The sum ACROSS the shards is inside the next launch: the group's
//     buffer holds every shard's packed partial of the last launch, a slot
//     a shard and a parity a sweep (parallel/seqpar.py, Columns.gather_),
//     and each block sums the gene's packed partials over the shards into
//     its shared memory in global shard order with plain float32 adds, the
//     bits ColumnGroup.combine's sum gives.  On one device the host does no tensor work a sweep; the
//     partials are double-buffered by sweep parity, so that a shard's next
//     launch never overwrites a slot another shard's launch of the same
//     sweep has yet to read.
//   * The launch bound names the blocks an SM (cols_min_blocks): without
//     it the compiler kept some instances to half their registers and
//     spilled; with one block an SM for every instance the PMAX = 4 ones
//     took 70 registers and ran one 512-thread block an SM, not two.
// What stays: X through device memory every sweep, a launch a sweep and
// its host call (CUDA graphs and a persistent kernel with a device-side
// exchange between shards are later work).
//
// A gene outside `act` writes a zero partial Gram (and zero u, K, E), so
// every shard reduces as often as the others whatever its genes.
#pragma once

#include "common.cuh"
#include "stream.cuh"  // DN_STREAM_CHUNK

// Floats of a gene's packed partial Gram (the upper triangle at PMAX).
template <int PMAX>
__host__ __device__ constexpr int cols_ng() {
  return PMAX * (PMAX + 1) / 2;
}

// Blocks an SM the launch bound asks the compiler for: two 512-thread
// blocks of a PMAX = 4 instance fit in 64 registers a thread (p = 3: 11.7
// against 16.6 ms a call at one block an SM); the others take one.
template <int PMAX>
__host__ __device__ constexpr int cols_min_blocks() {
  return PMAX <= 4 ? 2 : 1;
}

// The block's place: gene g, block `rank` of the gene's nb.
struct ColsBlock {
  size_t g;
  int rank;
  __device__ __forceinline__ explicit ColsBlock(int nb)
      : g(blockIdx.x / nb), rank((int)(blockIdx.x % nb)) {}
};

// Blocks of a gene that work in a launch after (a): one a dealt chunk, at
// most nb, at least one (it writes the gene's outputs).
__device__ __forceinline__ int cols_active_blocks(int ncols, int nb) {
  const int nch = (ncols + DN_STREAM_CHUNK - 1) / DN_STREAM_CHUNK;
  return nch < 1 ? 1 : (nch < nb ? nch : nb);
}

// A block's columns of one gene on the shard.  Local slot l is column
// ((l / CH) * nb + rank) * CH + l % CH of the shard.
//   F: (p, W) rows, float32 or raw int16 (I16, divided by the scales);
//   mask: (W) bytes; X: (p, W) rows of the multiplier scratch.
template <int PMAX, bool I16, bool FULL>
struct ColsSrc {
  const void* F;
  const uint8_t* __restrict__ mask;
  float* X;
  const float* ss;  // PMAX scales, then their reciprocals (shared memory)
  int p, W, rank, nb, nloc;

  // this block's chunks of the first nch: rank, rank + nb, ...
  __device__ __forceinline__ void deal(int nch) {
    nloc = (rank < nch ? (nch - rank + nb - 1) / nb : 0) * DN_STREAM_CHUNK;
  }
  __device__ __forceinline__ int col(int l) const {
    return ((l / DN_STREAM_CHUNK) * nb + rank) * DN_STREAM_CHUNK +
           (l % DN_STREAM_CHUNK);
  }
  __device__ __forceinline__ bool on(int l) const {
    if (l >= nloc) return false;
    const int w = col(l);
    return w < W && mask[w] != 0;
  }
  __device__ __forceinline__ float a_at(int w, int i) const {
    if (!DN_ROW(i)) return 0.f;
    const size_t at = (size_t)i * W + w;
    if (I16) return scaled_i16(((const int16_t*)F)[at], ss[i], ss[PMAX + i]);
    return ((const float*)F)[at];
  }
  __device__ __forceinline__ void load_x(int w, float (&x)[PMAX]) const {
#pragma unroll
    for (int i = 0; i < PMAX; ++i)
      x[i] = DN_ROW(i) ? X[(size_t)i * W + w] : 0.f;
  }
  __device__ __forceinline__ void store_x(int w, const float (&x)[PMAX]) const {
#pragma unroll
    for (int i = 0; i < PMAX; ++i)
      if (DN_ROW(i)) X[(size_t)i * W + w] = x[i];
  }
};

// The block's shared state: the warps' packed Gram partials (the block's
// sum goes into part[0]) and the scales.
template <int PMAX>
struct ColsSmem {
  static constexpr int NG = cols_ng<PMAX>();
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

// part[0][k] = the sum of the nw warps' part[w][k] in warp order.  Whole
// block; a barrier before (the partials written) and after (read).
template <int N, int MAXW>
__device__ __forceinline__ void cols_warps_sum(float (&part)[MAXW][N],
                                               int n) {
  const int nw = blockDim.x >> 5;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    float t = part[0][k];
    for (int w = 1; w < nw; ++w) t += part[w][k];
    part[0][k] = t;
  }
}

// The gene's partial over the shard from its `nact` blocks: this block's n
// floats in shared memory (bsum, complete after a barrier).  One block
// writes its own to out.  More: each writes its partial to bpart[rank] in
// device memory, and the last to arrive (the gene's integer ticket, which it
// resets for the next launch) sums the nact partials in block order into
// out.  Whole block.
__device__ __forceinline__ void cols_gene_store(const float* bsum, int n,
                                                float* __restrict__ out,
                                                float* bpart, int* ticket,
                                                int rank, int nact) {
  __shared__ int s_last;
  const int tid = threadIdx.x, nt = blockDim.x;
  if (nact == 1) {
    for (int k = tid; k < n; k += nt) out[k] = bsum[k];
    return;
  }
  float* mine = bpart + (size_t)rank * n;
  for (int k = tid; k < n; k += nt) mine[k] = bsum[k];
  __threadfence();  // this block's partial is visible before its ticket
  __syncthreads();
  if (tid == 0) {
    const int t = atomicAdd(ticket, 1);
    s_last = t == nact - 1;
    if (s_last) atomicExch(ticket, 0);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int k = tid; k < n; k += nt) {
    float t = __ldcg(bpart + k);
    for (int r = 1; r < nact; ++r) t += __ldcg(bpart + (size_t)r * n + k);
    out[k] = t;
  }
}

// The gene's Gram from the S shards' packed partials (`parts`: S slices
// `stride` floats apart, at this gene's) into `out` (shared memory), summed
// in shard order with plain float32 adds: the bits of ColumnGroup.combine's
// `red = parts[0].clone(); red += t` for each further shard.  Whole block;
// a barrier before the rows are read (load_gram_row).
template <int NG>
__device__ __forceinline__ void cols_sum_shards(const float* __restrict__ parts,
                                                size_t stride, int S,
                                                float* out) {
  for (int k = threadIdx.x; k < NG; k += blockDim.x) {
    float t = parts[k];
    for (int s = 1; s < S; ++s) t = __fadd_rn(t, parts[s * stride + k]);
    out[k] = t;
  }
}

// (a), and kernel 2c's first launch (X == nullptr: no multipliers kept).
// Every block walks its chunks of the whole shard; `ncols` (zeroed by the
// caller) receives the gene's last active column + 1.
template <int PMAX, bool I16, bool FULL>
__global__ void __launch_bounds__(32 * dn_max_warps<PMAX>(),
                                  cols_min_blocks<PMAX>())
    cols_gram_kernel(const void* __restrict__ F,
                     const uint8_t* __restrict__ mask,
                     const uint8_t* __restrict__ act,
                     const float* __restrict__ scale, float* X,
                     float* __restrict__ gram, float* bpart, int* tickets,
                     int* ncols, int p, int W, int nb) {
  constexpr int NG = cols_ng<PMAX>();
  __shared__ ColsSmem<PMAX> sm;
  extern __shared__ float tiles[];  // Gram tiles a warp (p >= 16)
  const ColsBlock b(nb);
  const size_t g = b.g;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31,
            warp = tid >> 5;
  float* out = gram + g * NG;
  if (act != nullptr && act[g] == 0) {
    if (b.rank == 0)
      for (int k = tid; k < NG; k += nt) out[k] = 0.f;
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
  src.rank = b.rank;
  src.nb = nb;
  src.deal((W + DN_STREAM_CHUNK - 1) / DN_STREAM_CHUNK);
  WarpGram<PMAX> acc;
  acc.init(tiles + (size_t)warp * warp_work_floats<PMAX>());
  acc.zero();
  int last = 0;
  for (int l0 = warp * 32; l0 < src.nloc; l0 += nt) {
    const int l = l0 + lane;
    const bool on = src.on(l);
    const int w = src.col(l);
    float x[PMAX];
#pragma unroll
    for (int i = 0; i < PMAX; ++i) x[i] = on ? src.a_at(w, i) : 0.f;
    if (on) {
      last = w + 1;
      if (X != nullptr) src.store_x(w, x);
    }
    acc.add(x, on, lane);
  }
  // an integer max: the same whatever the order
  last = __reduce_max_sync(DN_FULL, last);
  if (lane == 0 && last > 0) atomicMax(ncols + g, last);
  acc.flush(sm.part[warp], lane);
  __syncthreads();
  cols_warps_sum<NG>(sm.part, NG);
  __syncthreads();
  cols_gene_store(sm.part[0], NG, out, bpart + g * nb * NG, tickets + g,
                  b.rank, nb);
}

// (b): the power step on the summed partials `parts` (S shards), one merged
// sweep, the next partial Gram.  u_in == nullptr: the cold start
// 1 / sqrt(p).  ADAPT: s_in / s_out carry s, `done` the frozen genes, `it`
// is the iteration (0: the cold refit, which no freeze test follows).
template <int PMAX, bool I16, bool FULL, bool ADAPT>
__global__ void __launch_bounds__(32 * dn_max_warps<PMAX>(),
                                  cols_min_blocks<PMAX>())
    cols_sweep_kernel(const void* __restrict__ F,
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
  __shared__ ColsSmem<PMAX> sm;
  extern __shared__ float tiles[];  // a warp's Gram tile and u (p >= 16)
  const ColsBlock b(nb);
  const size_t g = b.g;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31,
            warp = tid >> 5;
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
  cols_load_scales<PMAX>(sm, scale, p);
  cols_sum_shards<NG>(parts + g * NG, (size_t)G * NG, S, sm.part[0]);
  __syncthreads();
  // every warp refits u from the same summed Gram: the same bits everywhere
  float u_lane = 0.f, s = 0.f;
  if (lane < p)
    u_lane = u_in != nullptr ? u_in[g * p + lane] : 1.0f / sqrtf((float)p);
  {
    float row[PMAX];
    load_gram_row<PMAX>(sm.part[0], lane, row);
    const float u_prev = u_lane;
    u_lane = power_refit<PMAX>(row, u_lane, n_squared, n_plain, ADAPT, s);
    if constexpr (ADAPT) {
      if (it > 0) {  // every warp of every block decides on the same bits
        const float k_old = __fmul_rn(u_prev, s_in[g]);
        const float k_new = __fmul_rn(u_lane, s);
        const float delta = warp_max(fabsf(k_new - k_old));
        const float ref = fmaxf(warp_max(fabsf(k_new)), DN_EPS);
        if (delta <= __fmul_rn(tol, ref)) {  // frozen: this refit kept
          if (lead) {
            for (int k = tid; k < NG; k += nt) out[k] = 0.f;
            if (warp == 0 && lane < p) u_out[g * p + lane] = u_lane;
            if (tid == 0) {
              s_out[g] = s;
              done[g] = 1;
            }
          }
          return;
        }
      }
    }
  }
  if (lead && warp == 0 && lane < p) u_out[g * p + lane] = u_lane;
  if (ADAPT && lead && tid == 0) s_out[g] = s;
  __syncthreads();  // every warp has its row before part[] is rewritten
  ColsSrc<PMAX, I16, FULL> src;
  src.F = I16 ? (const void*)((const int16_t*)F + g * p * W)
              : (const void*)((const float*)F + g * p * W);
  src.mask = mask + g * W;
  src.X = X + g * p * W;
  src.ss = sm.scale;
  src.p = p;
  src.W = W;
  src.rank = b.rank;
  src.nb = nb;
  src.deal((ncols[g] + DN_STREAM_CHUNK - 1) / DN_STREAM_CHUNK);
  const float step =
      nmf_iter > 0 ? (float)(1.0 / sqrt((double)nmf_iter)) : 0.f;
  float* work = tiles + (size_t)warp * warp_work_floats<PMAX>();
  WarpGram<PMAX> acc;
  acc.init(work);
  UVec<PMAX> u;
  u.init(work + PMAX * DN_TILE_STRIDE);
  u.set(u_lane, lane);
  acc.zero();
  for (int l0 = warp * 32; l0 < src.nloc; l0 += nt) {
    const int l = l0 + lane;
    const bool on = src.on(l);
    float x[PMAX];
#pragma unroll
    for (int i = 0; i < PMAX; ++i) x[i] = 0.f;
    if (on) {  // a column outside the mask stays exactly zero
      const int w = src.col(l);
      src.load_x(w, x);
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
        for (int i = 0; i < NC; ++i) a[i] = src.a_at(w, i0 + i);
#pragma unroll
        for (int i = 0; i < NC; ++i)
          x[i0 + i] = fmaxf(x[i0 + i] - step * (u[i0 + i] * se - a[i]), a[i]);
      }
      src.store_x(w, x);
    }
    acc.add(x, on, lane);
  }
  acc.flush(sm.part[warp], lane);
  __syncthreads();
  cols_warps_sum<NG>(sm.part, NG);
  __syncthreads();
  cols_gene_store(sm.part[0], NG, out, bpart + g * nb * NG, tickets + g,
                  b.rank, nact);
}

// (c): u and s from the summed partials `parts` (S shards), K = u s, E =
// X^T u / (s + eps) on the shard's columns (zero outside the mask).  ADAPT:
// a frozen gene's u and s (u_in, s_in) as they are.
template <int PMAX, bool FULL, bool ADAPT>
__global__ void __launch_bounds__(32 * dn_max_warps<PMAX>(),
                                  cols_min_blocks<PMAX>())
    cols_finish_kernel(const uint8_t* __restrict__ mask,
                       const uint8_t* __restrict__ act,
                       const float* __restrict__ X,
                       const float* __restrict__ parts, int S,
                       const int* __restrict__ ncols,
                       const float* __restrict__ u_in, float* __restrict__ K,
                       float* __restrict__ E, float* __restrict__ u_out,
                       const float* __restrict__ s_in,
                       const uint8_t* __restrict__ done, int G, int p, int W,
                       int n_squared, int n_plain, int nb) {
  constexpr int NG = cols_ng<PMAX>();
  __shared__ float gram[NG];        // the gene's Gram, summed over the shards
  extern __shared__ float tiles[];  // a warp's u (p >= 16)
  const ColsBlock b(nb);
  const size_t g = b.g;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31,
            warp = tid >> 5;
  const bool lead = b.rank == 0;
  float* Eg = E + g * W;
  const bool live = act == nullptr || act[g] != 0;
  const int nact = live ? cols_active_blocks(ncols[g], nb) : 1;
  if (b.rank >= nact) return;
  if (!live) {
    for (int w = tid; w < W; w += nt) Eg[w] = 0.f;
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
    cols_sum_shards<NG>(parts + g * NG, (size_t)G * NG, S, gram);
    __syncthreads();
    float row[PMAX];
    load_gram_row<PMAX>(gram, lane, row);
    u_lane = power_refit<PMAX>(row, u_lane, n_squared, n_plain, true, s);
  }
  if (lead && warp == 0 && lane < p) {
    K[g * p + lane] = u_lane * s;
    u_out[g * p + lane] = u_lane;
  }
  UVec<PMAX> u;
  u.init(tiles + (size_t)warp * warp_work_floats<PMAX>() +
         PMAX * DN_TILE_STRIDE);
  u.set(u_lane, lane);
  const int nch = (ncols[g] + DN_STREAM_CHUNK - 1) / DN_STREAM_CHUNK;
  const uint8_t* mg = mask + g * W;
  const float* Xg = X + g * p * W;
  ColsSrc<PMAX, false, FULL> src;  // the dealing alone
  src.rank = b.rank;
  src.nb = nb;
  src.deal(nch);
  for (int l0 = warp * 32; l0 < src.nloc; l0 += nt) {
    const int w = src.col(l0 + lane);
    if (l0 + lane >= src.nloc || w >= W) continue;
    float e = 0.f;
    if (mg[w] != 0) {
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < PMAX; ++i)
        if (DN_ROW(i)) v = fmaf(Xg[(size_t)i * W + w], u[i], v);
      e = v / (s + DN_EPS);
    }
    Eg[w] = e;
  }
  // E past the dealt chunks
  for (int w = nch * DN_STREAM_CHUNK + b.rank * nt + tid; w < W;
       w += nact * nt)
    Eg[w] = 0.f;
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
  const float* parts;  // (S, G, NG): every shard's partial of the last launch
  int S;
  int* ncols;          // (G): the gene's last active column + 1, from (a)
  const float* u_in;
  float* u_out;
  float* gram;         // (G, NG): this shard's partial of this launch
  float* bpart;        // (G, nb, NG): the blocks' partials (nb > 1)
  int* tickets;        // (G): zero between launches (nb > 1)
  float* K;
  float* E;
  const float* s_in;  // ADAPT: s carried from launch to launch
  float* s_out;
  float* s_fin;       // the wide finish: s of its refit (G)
  uint8_t* done;      // ADAPT: the frozen genes
  float tol;
  int it;
  int G, p, W, nmf_iter, n_squared, n_plain, nb, threads;
  cudaStream_t st;
};

template <int PM, bool I16, bool FULL, bool ADAPT>
static int cols_launch(int which, const ColsArgs& a) {
  if (a.threads > 32 * dn_max_warps<PM>()) return (int)cudaErrorInvalidValue;
  const size_t dyn = cols_dyn_bytes<PM>(a.threads);
  const dim3 grid((unsigned)((size_t)a.G * a.nb)), block((unsigned)a.threads);
  cudaError_t e;
  if (which == 0) {
    if constexpr (ADAPT) {
      return (int)cudaErrorInvalidValue;  // (a) has one instance, not ADAPT
    } else {
      e = cols_prepare(cols_gram_kernel<PM, I16, FULL>, dyn);
      if (e != cudaSuccess) return (int)e;
      cols_gram_kernel<PM, I16, FULL><<<grid, block, dyn, a.st>>>(
          a.F, a.mask, a.act, a.scale, a.X, a.gram, a.bpart, a.tickets,
          a.ncols, a.p, a.W, a.nb);
    }
  } else if (which == 1) {
    e = cols_prepare(cols_sweep_kernel<PM, I16, FULL, ADAPT>, dyn);
    if (e != cudaSuccess) return (int)e;
    cols_sweep_kernel<PM, I16, FULL, ADAPT><<<grid, block, dyn, a.st>>>(
        a.F, a.mask, a.act, a.scale, a.X, a.parts, a.S, a.ncols, a.u_in,
        a.u_out, a.gram, a.bpart, a.tickets, a.s_in, a.s_out, a.done, a.tol,
        a.it, a.G, a.p, a.W, a.nmf_iter, a.n_squared, a.n_plain, a.nb);
  } else if constexpr (I16) {
    return (int)cudaErrorInvalidValue;  // the finish reads no input: f32 TU
  } else {
    e = cols_prepare(cols_finish_kernel<PM, FULL, ADAPT>, dyn);
    if (e != cudaSuccess) return (int)e;
    cols_finish_kernel<PM, FULL, ADAPT><<<grid, block, dyn, a.st>>>(
        a.mask, a.act, a.X, a.parts, a.S, a.ncols, a.u_in, a.K, a.E, a.u_out,
        a.s_in, a.done, a.G, a.p, a.W, a.n_squared, a.n_plain, a.nb);
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
