// Shared device code of the DegNorm CUDA kernels for p > 128 samples
// (sm_90a, plain float32): the Lagrangian NMF-OA loop of one gene with its
// p x p Gram cut into row panels of DN_PANEL_ROWS, spread over a cluster of
// blocks (kernels 1 and 3 up to DN_PCL_MAX_P, kernels 2 and 4 up to
// DN_PCL_MAX_P_STREAM: dn_pcl_max_p); past its cut each kernel runs
// phase.cuh's phased layout, on this file's arithmetic.
//
// Replaces, for studies of more than 128 samples, wide.cuh's core (and so
// the same TPU code: degnorm_tpu/ops/pallas_nmf.py's _gram, _power,
// _power_warm and _nmf_loop, which ops/pallas_trim.py and
// ops/pallas_stream.py use the same way).  The TPU kernels have no cap on p;
// wide.cuh's layout stops at 128, because its Gram sits in shared memory as
// PMAX x (PMAX + 4) floats (266 KB at 256, against the 227 KB a block may
// have) and a thread's register tile of it is (PMAX / 16)^2 (256 registers
// at 256).  One instance here takes every p above 128.
//
// p is cut into T = ceil(p / 128) row panels.  The Gram's upper-triangle
// panel pairs (I <= J), T(T+1)/2 of them, are each accumulated over the
// gene's columns by wide.cuh's 8 x 8 register tile of WideGram<128> (syrk2:
// rows of panel I against rows of panel J of a tile of 64 columns in shared
// memory, both triangles of a diagonal pair with the same products in the
// same order, so B is exactly symmetric).  Two layouts place the pairs:
//
// THE CLUSTER LAYOUT (pcl_*: kernels 1 and 3 at p <= DN_PCL_MAX_P, T <= 5;
// kernels 2 and 4 at p <= DN_PCL_MAX_P_STREAM, T <= 9):
//   * a gene's T(T+1)/2 pairs over a thread-block cluster, the same number
//     of pairs a block but in the last: up to T = DN_PCL_MAX_C over at most
//     DN_PCL_MAX_C blocks (3 blocks of one pair at T = 2, 3 of two at 3, 5 of
//     two at 4, 5 of three at 5): the card holds 39 clusters of 3 or 22 of 5
//     at once, but 7 of 10 or 15, the sizes one pair a block would take at T
//     = 4 and 5; past it T blocks of ceil((T + 1) / 2) pairs (6 of four at T
//     = 6, 7 of four at 7, 8 of five at 8, 9 of five at 9: a cluster of 9 is
//     not portable and is asked for as such).  The diagonal pairs come
//     first: block P's first pair is (P, P).  Persistent clusters, as many as
//     the card holds at once (cudaOccupancyMaxActiveClusters), work through
//     the genes; a launch the card cannot hold fails, never falls back;
//   * a sweep goes over the gene's tiles once for every block's first pair.
//     X is stored column by column in the scratch (a column's rows
//     contiguous, dn_pcl_ldx floats), so each block copies its panels' rows
//     of a tile straight into one of two tiles in shared memory (16-byte
//     cp.async, a warp a column), and A0 as it is stored into a copy slot;
//     the next tile's copy is issued a whole tile ahead (A0 of float32
//     input, which has one slot, once this tile's is read);
//   * v = X^T u once a tile: each diagonal block sums its panel's rows
//     (each quarter's 32 rows in order, then the four quarters) and
//     publishes the partial in its shared memory; after one cluster barrier
//     every thread adds the T partials of its column in panel order.  (The
//     phased layout runs one chain a quarter over all panels: this order
//     differs, so the two layouts' fits are not bit-equal.)  Every block
//     then updates its panels of the tile in place, with the same
//     arithmetic on the same values, so the blocks agree bit for bit, and
//     the diagonal block writes its panel back to X, column by column.  A
//     block that holds more pairs goes over the tiles again for each, after
//     a cluster barrier, copying the new X back in;
//   * after a sweep each pair goes into B (with B^T where it is off the
//     diagonal, swizzled so that a warp reads down its columns): in the
//     block's own shared memory where the tiles were when a block holds one
//     pair, else in the cluster's slot of a workspace in device memory.
//     Up to T = DN_PCL_MAX_C every block runs the power step on the whole B
//     (map_shared_rank, or the workspace): B's largest entry from each
//     block's published one, each matvec a thread a row in column order j =
//     0 .. p - 1 as below, read down columns (a diagonal pair is symmetric,
//     an off-diagonal one has B^T), B^2 of the squared scheme by the same
//     blocks over B's rows read across the cluster (staged in the second
//     tile), each norm a block sum in a fixed order, so u and s are the same
//     in every block and across two runs.  Past it (B in the workspace,
//     4.2-9.0 MB at p = 768-1,152; kernel 4) and at every p (kernel 2) the
//     blocks share each matvec's reads of B: block P computes panel P's rows
//     of it, two threads a row each over half the columns in order, every
//     read down a column (B^2's transpose is stored too), publishes them in
//     its shared memory (two buffers by parity) and, after one cluster
//     barrier, every block copies the T panels' rows in panel order, so all
//     hold the same whole vector (pcl_matvec_rows);
//   * kernel 2 (A0_ONLY): the cold sweep's Gram of A0 with no X scratch (a
//     block's later pairs copy A0 again); after the cold power step one more
//     pass, v's partials published by the diagonal blocks, each of which
//     sums its panel's rows of A0 and of max(K E, A0) in column order
//     (ratio_panel.cu);
//   * what bounds it: float32 operations, T(T+1)/2 x 128^2 fmas a column a
//     sweep over the cluster's SMs, against one copy of X and A0 a block
//     that needs its rows and one write of X a sweep (a block's later pairs
//     copy X again); a cluster barrier a tile.  Shared memory: two tiles
//     (128 x 132 floats each), the A0 copies (64 KB), the v partials and 4
//     + DN_PCL_NX p-vectors, the published rows of a shared matvec
//     (dn_pcl_smem_floats: 218,768 bytes at p = 640, 231,056 at 1,152);
//     kernel 3 adds its W residual scores.
//
// PAST THE CLUSTER LAYOUT every kernel takes phase.cuh's phased layout,
// which keeps this file's reductions (panel_sum, panel_max,
// panel_renormalize, panel_stage) and the sums of the block layout it
// replaced (one block a gene, B in a workspace in device memory), in their
// order: a gene's pairs a block each over the whole card, the power step on
// a cluster of blocks a gene.
//
// Kept from common.cuh and wide.cuh: sums in a fixed order and no float
// atomics; plain FP32; no -use_fast_math.
#pragma once

#include <cooperative_groups.h>

#include "wide.cuh"

namespace cg = cooperative_groups;

#define DN_PANEL_ROWS 128                  // rows of a panel (WideGram<128>)
#define DN_PANEL_LD (DN_PANEL_ROWS + 4)    // floats a row of a staged tile
#define DN_PANEL_MIN_P 129                 // at and below 128: wide.cuh

// Rows of the panels that hold p (a whole number of panels).
__host__ __device__ inline int dn_panel_np(int p) {
  return (p + DN_PANEL_ROWS - 1) / DN_PANEL_ROWS * DN_PANEL_ROWS;
}

// The block's sum of its threads' values in a fixed order (warps, then the
// warps' sums in order), and its largest value: the same in every thread.
// Each starts and ends with a barrier of its own use of `red`.
__device__ __forceinline__ float panel_sum(float* red, float v) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = 0.f;
#pragma unroll
  for (int k = 0; k < DN_WIDE_THREADS / 32; ++k) r += red[k];
  __syncthreads();
  return r;
}

__device__ __forceinline__ float panel_max(float* red, float v) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int k = 1; k < DN_WIDE_THREADS / 32; ++k) r = fmaxf(r, red[k]);
  __syncthreads();
  return r;
}

// This thread's 32 rows of panel P of its column of a tile into S (column
// c's rows contiguous), from val(i); zeros off `on` and past p.
template <class Val>
__device__ __forceinline__ void panel_stage(float* S, int P, int p, bool on,
                                            const Val& val) {
  const int t = threadIdx.x, q = t >> 6, c = t & (DN_WIDE_TC - 1);
  const int i0 = P * DN_PANEL_ROWS + q * 32;
  float* Sc = S + c * DN_PANEL_LD + q * 32;
#pragma unroll 2
  for (int k4 = 0; k4 < 32; k4 += 4) {
    float x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + k4 + j;
      x[j] = (on && i < p) ? val(i) : 0.f;
    }
    wide_st<4>(Sc + k4, x);
  }
}

// u = wv / |wv| over p rows, keeping u where the update collapsed; wv
// visible, `red` the block's 32 floats of scratch.  Ends with a barrier.
__device__ __forceinline__ void panel_renormalize(float* red, int p,
                                                  const float* wv, float* u) {
  float n2 = 0.f;
  for (int j = threadIdx.x; j < p; j += DN_WIDE_THREADS)
    n2 = fmaf(wv[j], wv[j], n2);
  const float nrm = sqrtf(panel_sum(red, n2));
  if (nrm > DN_EPS)
    for (int i = threadIdx.x; i < p; i += DN_WIDE_THREADS)
      u[i] = wv[i] / (nrm + DN_EPS);
  __syncthreads();
}

// ---- the cluster layout: a gene's panel pairs over a cluster of blocks -----
// (kernels 1-4 where the header comment above says; it says how it works)

// Most p of the cluster layout, a rule by kernel (dn_pcl_max_p): kernels 1
// and 3 (DN_PCL_LOOP) up to T = 5 panels, kernels 2 and 4 (DN_PCL_STREAM) up
// to T = 9, on clusters of T blocks past T = 5
#define DN_PCL_MAX_P 640
#define DN_PCL_MAX_P_STREAM 1152
#define DN_PCL_LOOP 0
#define DN_PCL_STREAM 1
#define DN_PCL_PAIR (DN_PANEL_ROWS * DN_PANEL_LD)  // floats of a stored pair
#define DN_PCL_STAGE_A (2 * DN_PANEL_ROWS * DN_WIDE_TC)  // floats of A0 copies
#define DN_PCL_BT 32      // rows of B a tile of B^2's staging
#define DN_PCL_NX 2       // p-vectors of the kernel's own
// Most blocks of a gene's cluster up to T = DN_PCL_MAX_C panels: the card
// holds 39 clusters of 3 at once but 7 of 10 or 15 (whole clusters on one of
// its GPCs, an SM a block), so above DN_PCL_MAX_C pairs a block holds
// several; past T = DN_PCL_MAX_C a cluster has T blocks (each diagonal pair
// a block's first), of which the card's portable limit is DN_PCL_PORTABLE
#define DN_PCL_MAX_C 5
#define DN_PCL_PORTABLE 8

__host__ __device__ inline int dn_pcl_max_p(int kind) {
  return kind == DN_PCL_STREAM ? DN_PCL_MAX_P_STREAM : DN_PCL_MAX_P;
}
__host__ __device__ inline bool dn_pcl_on(int p, int kind) {
  return p >= DN_PANEL_MIN_P && p <= dn_pcl_max_p(kind);
}

// Panels of p, their pairs, the pairs a block holds and the blocks of a
// gene's cluster: T(T+1)/2 pairs over at most max(T, DN_PCL_MAX_C) blocks,
// the same number a block but in the last (3 blocks of one pair at T = 2, 3
// of two at 3, 5 of two at 4, 5 of three at 5; T blocks of ceil((T + 1) /
// 2) past 5).
__host__ __device__ inline int dn_pcl_T(int p) {
  return dn_panel_np(p) / DN_PANEL_ROWS;
}
__host__ __device__ inline int dn_pcl_pairs(int p) {
  const int T = dn_pcl_T(p);
  return T * (T + 1) / 2;
}
__host__ __device__ inline int dn_pcl_held(int p) {
  const int c = dn_pcl_T(p) > DN_PCL_MAX_C ? dn_pcl_T(p) : DN_PCL_MAX_C;
  return (dn_pcl_pairs(p) + c - 1) / c;
}
__host__ __device__ inline int dn_pcl_size(int p) {
  const int h = dn_pcl_held(p);
  return (dn_pcl_pairs(p) + h - 1) / h;
}
// Past T = DN_PCL_MAX_C the blocks share the power step's matvecs, a panel
// of rows each (pcl_matvec)
__host__ __device__ inline bool dn_pcl_shared_power(int p) {
  return dn_pcl_T(p) > DN_PCL_MAX_C;
}
// Floats of a cluster's workspace where its blocks hold several pairs: B,
// B^2, B^T and (where the blocks share the power step) B^2's transpose of
// every pair (0 where a block holds one: then they are in the cluster's
// shared memory).
__host__ __device__ inline size_t dn_pcl_ws_floats(int p) {
  if (dn_pcl_held(p) == 1) return 0;
  return (size_t)dn_pcl_pairs(p) *
         (2 * DN_PCL_PAIR + 2 * DN_PANEL_ROWS * DN_PANEL_ROWS);
}

// Floats a gene's column of X takes in the scratch of the cluster layout
// (X stored column by column: a panel's rows of a column are contiguous and
// 16-byte aligned).
__host__ __device__ inline int dn_pcl_ldx(int p) { return (p + 3) / 4 * 4; }

// Pair e of T panels -> its panels (I, J), I <= J: the diagonal pairs first
// (e = I < T, block I of the cluster), then the others in row order.
__host__ __device__ inline void dn_pcl_pair(int T, int e, int& I, int& J) {
  if (e < T) {
    I = J = e;
    return;
  }
  e -= T;
  I = 0;
  while (e >= T - 1 - I) {
    e -= T - 1 - I;
    ++I;
  }
  J = I + 1 + e;
}
__host__ __device__ inline int dn_pcl_index(int T, int I, int J) {
  return I == J ? I : T + I * (T - 1) - I * (I - 1) / 2 + (J - I - 1);
}

// Floats of the cluster core's dynamic shared memory: two tiles S (two
// panels' columns a tile, rows of LD; after a sweep B and, in the squared
// scheme, B^2's staging and B^2), the copies of A0 (two slots of int16, or
// one of float32: DN_PCL_STAGE_A floats either way; after a sweep B^T), the
// v partials, the published panel partials (two tiles' worth), 32 floats of
// scratch, the published largest entry (4), 4 + DN_PCL_NX p-vectors, and
// the published rows of a matvec where the blocks share the power step (two
// panels' worth).
__host__ __device__ inline int dn_pcl_smem_floats(int p) {
  return 2 * DN_PCL_PAIR + DN_PCL_STAGE_A + 6 * DN_WIDE_TC + 32 + 4 +
         (4 + DN_PCL_NX) * dn_panel_np(p) + 2 * DN_PANEL_ROWS;
}

// A block's share of its gene's cluster, in its dynamic shared memory: S
// and the offsets of the rest from it (computed where used, so that a
// kernel holds one pointer to it in registers, not one a part).
template <class A>
struct PclWork {
  static constexpr int NA = sizeof(A) == 2 ? 2 : 1;  // slots of A0 copies
  // S: 2 x (TC x LD a panel): the tiles, panel I then J; after a sweep this
  // block's pair of B in tile 0 (128 x LD), and in the squared scheme B^2's
  // staging, then its pair, in tile 1
  float* S;
  float* X;      // the gene's X in the scratch, column l at X + l * ldx
  float* ws;     // the cluster's workspace where a block holds several
                 // pairs (dn_pcl_ws_floats: B, B^2, B^T by pair), else null
  int p, np, T, C, rank, I, J, ldx, npairs, held;
  int nact;      // tiles whose v went through wbuf (its parity picks half)
  int npow;      // shared matvecs published (its parity picks ypub's half)
  bool shared;   // the blocks share the power step (pcl_matvec)
  // share_power: the blocks share the power step at every p (kernel 2),
  // else past T = DN_PCL_MAX_C (dn_pcl_shared_power)
  __device__ __forceinline__ void init(float* smem, int p_, int rank_,
                                       float* ws_ = nullptr,
                                       bool share_power = false) {
    p = p_;
    np = dn_panel_np(p_);
    T = np / DN_PANEL_ROWS;
    C = dn_pcl_size(p_);
    npairs = dn_pcl_pairs(p_);
    held = dn_pcl_held(p_);
    rank = rank_;
    ldx = dn_pcl_ldx(p_);
    ws = ws_;
    hold(0);
    nact = 0;
    npow = 0;
    shared = share_power || dn_pcl_shared_power(p_);
    S = smem;
  }
  // NA x (128 x TC a panel): copies of A0, as stored ...
  __device__ __forceinline__ A* sta() const {
    return (A*)(S + 2 * DN_PCL_PAIR);
  }
  // ... the same place after a sweep: B^T of this block's pair where it is
  // off the diagonal (pair_t)
  __device__ __forceinline__ float* bst() const { return S + 2 * DN_PCL_PAIR; }
  // 4 x TC: the quarters' partials of v
  __device__ __forceinline__ float* vpart() const {
    return S + 2 * DN_PCL_PAIR + DN_PCL_STAGE_A;
  }
  // 2 x TC: this block's panel partial of v, published
  __device__ __forceinline__ float* wbuf() const {
    return vpart() + 4 * DN_WIDE_TC;
  }
  __device__ __forceinline__ float* red() const {  // 32: block reductions
    return wbuf() + 2 * DN_WIDE_TC;
  }
  // 1: the largest entry of this block's pairs, published
  __device__ __forceinline__ float* pmax() const { return red() + 32; }
  // np each: the left vector (zero beyond p), two matvec results, the
  // previous u (ADAPT), then the kernel's own DN_PCL_NX
  __device__ __forceinline__ float* u() const { return pmax() + 4; }
  __device__ __forceinline__ float* va() const { return u() + np; }
  __device__ __forceinline__ float* vb() const { return u() + 2 * np; }
  __device__ __forceinline__ float* uo() const { return u() + 3 * np; }
  __device__ __forceinline__ float* x(int k) const {
    return u() + (4 + k) * np;
  }
  // 2 x 128: this block's panel rows of a matvec, published (where shared)
  __device__ __forceinline__ float* ypub() const {
    return u() + (4 + DN_PCL_NX) * np;
  }
  // this block's h-th pair, pair rank + h C, as (I, J); false past the last
  // (a block's first pair: its panel partials of v and its write-back)
  __device__ __forceinline__ bool hold(int h) {
    const int e = rank + h * C;
    if (e >= npairs) return false;
    dn_pcl_pair(T, e, I, J);
    return true;
  }
  __device__ __forceinline__ bool diag() const { return I == J; }
  __device__ __forceinline__ float* tile(int b) const {
    return S + b * DN_PCL_PAIR;
  }
  __device__ __forceinline__ A* slot(int b) const {
    return sta() + (NA == 2 ? b : 0) * (DN_PCL_STAGE_A * 4 / (int)sizeof(A) / NA);
  }
  // pair e of B (or of B^2, `two`): in the shared memory of block e where
  // a block holds one pair, else in the workspace
  __device__ __forceinline__ float* pair(int e, bool two) const {
    if (ws != nullptr)
      return ws + (size_t)((two ? npairs : 0) + e) * DN_PCL_PAIR;
    return cg::this_cluster().map_shared_rank(tile(two ? 1 : 0), e);
  }
  // B^T of the off-diagonal pair e (I < J): B[I R + ii][J R + jj] at jj R +
  // (ii ^ (jj >> 3)), so that consecutive ii (a warp reading down a column
  // of the pair) stay within one 128-byte line
  __device__ __forceinline__ float* pair_t(int e) const {
    if (ws != nullptr)
      return ws + (size_t)2 * npairs * DN_PCL_PAIR +
             (size_t)e * DN_PANEL_ROWS * DN_PANEL_ROWS;
    return cg::this_cluster().map_shared_rank(bst(), e);
  }
};

// The first tile at or after k with an active column, or ntile
// (block-uniform).
template <class Src>
__device__ __forceinline__ int pcl_next(const Src& src, int k, int ntile) {
  const int c = threadIdx.x & (DN_WIDE_TC - 1);
  for (; k < ntile; ++k)
    if (__syncthreads_or(src.on(k * DN_WIDE_TC + c))) return k;
  return ntile;
}

// This block's panels' rows of X for the columns l0 .. l0 + 63 into tile b,
// as the tile holds them (a column's rows contiguous): warp w copies the
// columns w, w + 8, ..., lane r the 16 bytes of rows 4r .. 4r + 3 (16-byte
// cp.async); rows past p's last group of four and columns past the gene's
// last are not copied.  The caller commits.
template <class Src, class A>
__device__ __forceinline__ void pcl_stage_x(const Src& src, PclWork<A>& w,
                                            int l0, int b) {
  constexpr int TC = DN_WIDE_TC, R = DN_PANEL_ROWS, LD = DN_PANEL_LD;
  const int valid = src.valid_cols(l0), lane = threadIdx.x & 31;
  const int nb = w.diag() ? 1 : 2;
  for (int pn = 0; pn < nb; ++pn) {
    const int i0 = (pn ? w.J : w.I) * R;
    if (4 * lane >= w.ldx - i0) continue;
    float* St = w.tile(b) + pn * TC * LD + 4 * lane;
    const float* Xs = w.X + (size_t)l0 * w.ldx + i0 + 4 * lane;
    // (no loop of copies is unrolled: their addresses in flight spilled)
#pragma unroll 1
    for (int cc = threadIdx.x >> 5; cc < valid; cc += DN_WIDE_THREADS / 32)
      dn_cp_async16(St + cc * LD, Xs + (size_t)cc * w.ldx);
  }
}

// ... and its rows of A0 into slot b, as they are stored: 16-byte cp.async
// copies where the rows are 16-byte aligned (Src::vec()), else plain loads;
// rows past p and columns past the gene's last are not copied.
template <class Src, class A>
__device__ __forceinline__ void pcl_stage_a(const Src& src, PclWork<A>& w,
                                            int l0, int b) {
  constexpr int TC = DN_WIDE_TC, R = DN_PANEL_ROWS, AV = 16 / sizeof(A);
  const int valid = src.valid_cols(l0), t = threadIdx.x;
  const int nb = w.diag() ? 1 : 2;
  for (int pn = 0; pn < nb; ++pn) {
    const int i0 = (pn ? w.J : w.I) * R;
    const int rows = w.p - i0 < R ? w.p - i0 : R;
    A* sa = w.slot(b) + pn * R * TC;
    if (src.vec()) {
#pragma unroll 1
      for (int k = t; k < rows * (TC / AV); k += DN_WIDE_THREADS) {
        const int r = k / (TC / AV), j = (k % (TC / AV)) * AV;
        if (j < valid) dn_cp_async16(sa + r * TC + j, src.arow(i0 + r, l0) + j);
      }
    } else {
#pragma unroll 1
      for (int k = t; k < rows * TC; k += DN_WIDE_THREADS) {
        const int r = k / TC, j = k % TC;
        if (j < valid) sa[r * TC + j] = src.arow(i0 + r, l0)[j];
      }
    }
  }
}

// v of a tile's columns: the diagonal blocks publish their panel's partial
// (each quarter's 32 rows in order, then the four quarters in a fixed
// order), one cluster barrier, and every thread sums the T partials of its
// column in panel order.  `xc`: this thread's column's rows of panel I (16-
// byte aligned; read where `on`, in groups of four below p).  Every block
// of the cluster calls it for the same tiles.
template <class A>
__device__ __forceinline__ float pcl_v(PclWork<A>& w, bool on,
                                       const float* xc) {
  constexpr int TC = DN_WIDE_TC;
  const int t = threadIdx.x, q = t >> 6, c = t & (TC - 1);
  const int par = (w.nact & 1) * TC;
  ++w.nact;
  if (w.diag()) {
    float vp = 0.f;
    if (on) {
      const int i0 = w.I * DN_PANEL_ROWS + q * 32;
#pragma unroll 2
      for (int j4 = 0; j4 < 32; j4 += 4) {
        if (i0 + j4 >= w.p) break;
        float x4[4];
        wide_ld<4>(xc + q * 32 + j4, x4);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (i0 + j4 + jj < w.p) vp = fmaf(x4[jj], w.u()[i0 + j4 + jj], vp);
      }
    }
    w.vpart()[q * TC + c] = vp;
    __syncthreads();
    if (t < TC)
      w.wbuf()[par + t] =
          ((w.vpart()[t] + w.vpart()[TC + t]) + w.vpart()[2 * TC + t]) +
          w.vpart()[3 * TC + t];
  }
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();  // the partials are published (and the last tile's are read)
  float v = 0.f;
  for (int P = 0; P < w.T; ++P) v += cl.map_shared_rank(w.wbuf(), P)[par + c];
  return v;
}

// One pass of a block over the gene's tiles for its pair (w.I, w.J) into
// the register tile `g`: each tile's rows copied (X where want_x, A0 where
// want_a) into one of two tiles, the next tile's copy in flight through
// this tile, then in place the tile's new X: with UPD (a merged sweep's
// first pass) v and the multiplier update, else A0 (want_a) or the X
// copied, zero off the mask and past p; the diagonal block of a first pass
// writes its panel back to X.  UPD passes are the cluster's (a cluster
// barrier a tile, in pcl_v), the others the block's.  A0_ONLY (kernel 2):
// no X to write back.
template <bool ADAPT, bool UPD, bool A0_ONLY = false, class Src, class A>
__device__ __forceinline__ void pcl_pass(const Src& src, PclWork<A>& w,
                                         WideGram<128>& g, float step,
                                         float s, bool want_x, bool want_a) {
  constexpr int TC = DN_WIDE_TC, LD = DN_PANEL_LD, R = DN_PANEL_ROWS;
  constexpr int NA = PclWork<A>::NA;
  const int t = threadIdx.x, q = t >> 6, c = t & (TC - 1), p = w.p;
  const int ntile = (src.n_local() + TC - 1) / TC;
  const int nb = w.diag() ? 1 : 2;
  const bool write_x = !A0_ONLY && w.diag() && want_a;
  const auto stage = [&](int kk, int b, bool x, bool a) {
    if (x) pcl_stage_x(src, w, kk * TC, b);
    if (a) pcl_stage_a(src, w, kk * TC, b);
  };
  g.zero();
  int k = pcl_next(src, 0, ntile);
  int kn = k < ntile ? pcl_next(src, k + 1, ntile) : ntile;
  bool on = k < ntile && src.on(k * TC + c);      // this thread's column of
  bool on_n = kn < ntile && src.on(kn * TC + c);  // tile k, of tile kn
  if (k < ntile) stage(k, 0, want_x, want_a);
  dn_cp_async_commit();
  for (int n = 0; k < ntile; ++n) {
    const int b = n & 1;
    const int k2 = kn + 1;  // the vote on the tile after next: loads issued
    const bool on2 = k2 < ntile && src.on(k2 * TC + c);
    dn_cp_async_wait_all();
    // tile k is in tile b (and its A0 in its slot), and the last tile's
    // Gram has read tile b ^ 1
    __syncthreads();
    // the next tile's copy, in flight through this tile (A0 too where it
    // has a slot of its own)
    if (kn < ntile) stage(kn, b ^ 1, want_x, want_a && NA == 2);
    dn_cp_async_commit();
    float se = 0.f;
    float* St = w.tile(b);
    if constexpr (UPD) {
      const float v = pcl_v(w, on, St + c * LD);
      // ADAPT: est = K_i E_w taken as u_i (s E_w), as nmf_core does
      se = ADAPT ? __fmul_rn(s, v / (s + DN_EPS)) : v;
    }
    for (int pn = 0; pn < nb; ++pn) {
      const int P = pn ? w.J : w.I;
      const A* as = w.slot(b) + pn * R * TC;
      float* Sc = St + pn * TC * LD + c * LD + q * 32;
#pragma unroll 2
      for (int k4 = 0; k4 < 32; k4 += 4) {
        float x4[4], u4[4];
        if (want_x) wide_ld<4>(Sc + k4, x4);
        if constexpr (UPD) wide_ld<4>(w.u() + P * R + q * 32 + k4, u4);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int row = q * 32 + k4 + jj, i = P * R + row;
          float xv = 0.f;
          if (on && i < p) {  // a column outside the mask stays zero
            if (want_a) {
              const float a = src.a0v(as[row * TC + c], i);
              if constexpr (UPD)
                xv = fmaxf(x4[jj] - step * (u4[jj] * se - a), a);
              else
                xv = a;
            } else {
              xv = x4[jj];
            }
          }
          x4[jj] = xv;
        }
        wide_st<4>(Sc + k4, x4);
      }
    }
    const bool any2 = __syncthreads_or(on2);  // the tile is in place
    // the diagonal block's panel of it back to X, a column's rows by
    // consecutive threads (off the mask and past p: zeros, never read)
    if (write_x && 4 * (t & 31) < w.ldx - w.I * R) {
      float* Xt = w.X + (size_t)k * TC * w.ldx + w.I * R + 4 * (t & 31);
      const float* Sl = St + 4 * (t & 31);
#pragma unroll 1
      for (int cc = t >> 5; cc < src.valid_cols(k * TC);
           cc += DN_WIDE_THREADS / 32)
        *(float4*)(Xt + (size_t)cc * w.ldx) = *(const float4*)(Sl + cc * LD);
    }
    const int knn = kn >= ntile ? ntile
                    : any2      ? k2
                                : pcl_next(src, k2 + 1, ntile);
    // one slot of A0: the next tile's copy once this one's is read
    if (NA == 1 && want_a && kn < ntile) stage(kn, b ^ 1, false, true);
    dn_cp_async_commit();
    g.syrk2<LD>(St, nb == 2 ? St + TC * LD : St, TC);
    on = on_n;
    on_n = knn == k2 ? on2 : knn < ntile && src.on(knn * TC + c);
    k = kn;
    kn = knn;
  }
  dn_cp_async_wait_all();
  __syncthreads();  // the last tile's Gram has read its tile
}

// A block's pair `e` from its register tile `g` into B (tile 0 where a
// block holds one pair, else the workspace), with B^T of an off-diagonal
// pair for reads down its columns; returns the pair's largest |entry|.
template <class A>
__device__ __forceinline__ float pcl_store(const PclWork<A>& w,
                                           const WideGram<128>& g, int e) {
  constexpr int R = DN_PANEL_ROWS;
  g.store(w.ws != nullptr ? w.pair(e, false) : w.tile(0));
  if (!w.diag()) {
    float* Bt = w.ws != nullptr ? w.pair_t(e) : w.bst();
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int s2 = 0; s2 < 8; ++s2) {
        const int jj = g.tx * 8 + s2, ii = g.ty * 8 + r;
        Bt[jj * R + (ii ^ (jj >> 3))] = g.acc[r][s2];
      }
  }
  float m = 0.f;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int s2 = 0; s2 < 8; ++s2) m = fmaxf(m, fabsf(g.acc[r][s2]));
  return m;
}

// A block's later pairs (where it holds several): for each, after a
// cluster barrier (the first pass's new X is back in the scratch), a pass
// over the tiles copying X in (A0_ONLY: A0 again, with no barrier), and the
// pair into B.  Compiled out of line with its own register tile (inline,
// beside the first pass, the kernel's registers spilled), its arguments
// values.  Returns the pairs' largest |entry| (0 where the block has none).
template <bool A0_ONLY, class Src, class A>
static __device__ __noinline__ float pcl_later_pairs(Src src, PclWork<A> w) {
  WideGram<128> g;
  float m = 0.f;
  for (int h = 1; h < w.held; ++h) {
    if constexpr (!A0_ONLY) cg::this_cluster().sync();
    if (!w.hold(h)) continue;
    pcl_pass<false, false, A0_ONLY>(src, w, g, 0.f, 0.f, !A0_ONLY, A0_ONLY);
    m = fmaxf(m, pcl_store(w, g, w.rank + h * w.C));
  }
  return m;
}

// One sweep of the cluster over the gene's tiles: the cold one (MERGED
// false: X = A0, or the X held where from_x) or a merged one (v, the
// multiplier update, the Gram of the new X), a pass for each pair a block
// holds: its first pair's pass reads each tile's rows once into each block
// that needs them and writes the new X back; a later pair's pass copies
// the new X back in.  Each pair goes into B (with B^T off the diagonal); returns the largest
// |B| entry of the cluster.  A0_ONLY (kernel 2's cold sweep): the Gram of
// A0 with no X scratch.
template <bool ADAPT, bool MERGED, bool A0_ONLY = false, class Src, class A>
__device__ __forceinline__ float pcl_sweep(const Src& src, PclWork<A>& w,
                                           WideGram<128>& g, float step,
                                           float s, bool from_x) {
  cg::cluster_group cl = cg::this_cluster();
  // every block is done with the last power step's reads of this block's B
  // and B^2, whose places the tiles take
  cl.sync();
  pcl_pass<ADAPT, MERGED, A0_ONLY>(src, w, g, step, s, MERGED || from_x,
                                   MERGED || !from_x);
  float m = pcl_store(w, g, w.rank);
  if (w.held > 1) m = fmaxf(m, pcl_later_pairs<A0_ONLY>(src, w));
  m = panel_max(w.red(), m);
  if (threadIdx.x == 0) *w.pmax() = m;
  cl.sync();  // B and its largest entries are published
  float bm = 0.f;
  for (int r = 0; r < w.C; ++r)
    bm = fmaxf(bm, *cl.map_shared_rank(w.pmax(), r));
  return bm;
}

// y = (scale M) x over p rows, M = B (tiles `m0` of the cluster's blocks,
// with `mt` their B^T) or B^2 (`two`: tiles `m1`), every block the whole of
// y: thread i sums row i in order of j, as panel_matvec, reading M[i][j] =
// M[j][i] down a column of the pair that holds it (a warp's threads on
// consecutive addresses): of pair (J, I) for J >= I (a diagonal pair is
// symmetric), of B^T for I < J, and along a row of B^2's pair (I, J), which
// has no transpose.  Compiled once, out of line (its unrolled loads beside
// a kernel's own registers spilled), so its arguments are values.  Ends
// with a barrier: y is visible.
static __device__ __noinline__ void pcl_matvec(int p, int T, const float* m0,
                                               const float* m1,
                                               const float* mt,
                                               const float* ws, int npairs,
                                               bool two, float scale,
                                               const float* x, float* y) {
  constexpr int R = DN_PANEL_ROWS, LD = DN_PANEL_LD;
  cg::cluster_group cl = cg::this_cluster();
  // (PclWork::pair and pair_t, from values)
  const auto pair = [&](int e) -> const float* {
    if (ws != nullptr)
      return ws + (size_t)((two ? npairs : 0) + e) * DN_PCL_PAIR;
    return cl.map_shared_rank(two ? m1 : m0, e);
  };
  const auto pair_t = [&](int e) -> const float* {
    if (ws != nullptr)
      return ws + (size_t)2 * npairs * DN_PCL_PAIR + (size_t)e * R * R;
    return cl.map_shared_rank(mt, e);
  };
  for (int i = threadIdx.x; i < p; i += DN_WIDE_THREADS) {
    const int I = i / R, ii = i % R;
    float v = 0.f;
    for (int J = 0; J < T; ++J) {
      const int n = p - J * R < R ? p - J * R : R;
      const float* xj = x + J * R;
      if (I < J && two) {
        const float* m = pair(dn_pcl_index(T, I, J)) + ii * LD;
#pragma unroll 16
        for (int jj = 0; jj < n; ++jj) v = fmaf(m[jj] * scale, xj[jj], v);
      } else if (I < J) {
        const float* m = pair_t(dn_pcl_index(T, I, J));
#pragma unroll 16
        for (int jj = 0; jj < n; ++jj)
          v = fmaf(m[jj * R + (ii ^ (jj >> 3))] * scale, xj[jj], v);
      } else {
        const float* m = pair(dn_pcl_index(T, J, I)) + ii;
#pragma unroll 16
        for (int jj = 0; jj < n; ++jj)
          v = fmaf(m[jj * LD] * scale, xj[jj], v);
      }
    }
    y[i] = v;
  }
  __syncthreads();
}

// The shared matvec: rows P * 128 .. of y = (scale M) x into yo[i - P *
// 128], by block P, two threads a row: thread t < 128 sums over the first
// ceil(T / 2) panels of columns, t >= 128 over the rest, each in column
// order j, and row i is the first sum plus the second.  Every read goes down
// a column of the pair that holds the entries, a warp's threads on
// consecutive addresses: pair (J, P) for J <= P (a diagonal pair is
// symmetric), and for J > P the transpose of pair (P, J), B^T or (two) B^2's;
// where it holds no transpose (`bt_ok` false: a block of one pair that keeps
// B^2's in its place), along a row of pair (P, J) of B.  `half`: 128 floats
// of the block's scratch.  Compiled once, out of line, so its arguments are
// values.  Ends with a barrier: yo is visible.
static __device__ __noinline__ void pcl_matvec_rows(
    int p, int T, int P, const float* m0, const float* m1, const float* mt,
    const float* ws, int npairs, bool two, bool bt_ok, float scale,
    const float* x, float* yo, float* half) {
  constexpr int R = DN_PANEL_ROWS, LD = DN_PANEL_LD;
  cg::cluster_group cl = cg::this_cluster();
  const int t = threadIdx.x, ii = t & (R - 1), h = t >> 7;
  const int i = P * R + ii, Jm = (T + 1) / 2;
  // (PclWork::pair and pair_t, from values; B^2's transpose after B^T's)
  const auto pair = [&](int e, bool b2) -> const float* {
    if (ws != nullptr)
      return ws + (size_t)((b2 ? npairs : 0) + e) * DN_PCL_PAIR;
    return cl.map_shared_rank(b2 ? m1 : m0, e);
  };
  const auto pair_t = [&](int e, bool b2) -> const float* {
    if (ws != nullptr)
      return ws + (size_t)2 * npairs * DN_PCL_PAIR +
             (size_t)((b2 ? npairs : 0) + e) * R * R;
    return cl.map_shared_rank(mt, e);
  };
  float v = 0.f;
  if (i < p) {
    for (int J = h ? Jm : 0; J < (h ? T : Jm); ++J) {
      const int n = p - J * R < R ? p - J * R : R;
      const float* xj = x + J * R;
      if (J <= P) {
        const float* m = pair(dn_pcl_index(T, J, P), two) + ii;
#pragma unroll 32
        for (int jj = 0; jj < n; ++jj) v = fmaf(m[jj * LD] * scale, xj[jj], v);
      } else if (two || bt_ok) {
        const float* m = pair_t(dn_pcl_index(T, P, J), two);
#pragma unroll 32
        for (int jj = 0; jj < n; ++jj)
          v = fmaf(m[jj * R + (ii ^ (jj >> 3))] * scale, xj[jj], v);
      } else {
        const float* m = pair(dn_pcl_index(T, P, J), false) + ii * LD;
#pragma unroll 16
        for (int jj = 0; jj < n; ++jj) v = fmaf(m[jj] * scale, xj[jj], v);
      }
    }
  }
  if (h) half[ii] = v;
  __syncthreads();
  if (!h && i < p) yo[ii] = v + half[ii];
  __syncthreads();
}

// y = (scale M) x: every row in every block (pcl_matvec above), or where
// the blocks share the power step (w.shared: each panel has a block, block P
// its panel P) this block's panel's rows (pcl_matvec_rows) into its
// published half of ypub, one cluster barrier, and every block's whole y
// copied from the T blocks in panel order.  A half is written again two
// matvecs later, after the next one's barrier, by which every block has
// copied it.  `bt_ok`: see pcl_matvec_rows.  SHARE: the kernel's blocks
// may share the power step (kernels 2 and 4; kernels 1 and 3 never do, and
// compile no shared path).  Ends with a barrier: y is visible.
template <bool SHARE, class A>
__device__ __forceinline__ void pcl_matvec(PclWork<A>& w, bool two,
                                           float scale, const float* x,
                                           float* y, bool bt_ok = true) {
  constexpr int R = DN_PANEL_ROWS;
  if (!SHARE || !w.shared) {
    pcl_matvec(w.p, w.T, w.tile(0), w.tile(1), w.bst(), w.ws, w.npairs, two,
               scale, x, y);
    return;
  }
  const int par = (w.npow & 1) * R;
  ++w.npow;
  if (w.rank < w.T)
    pcl_matvec_rows(w.p, w.T, w.rank, w.tile(0), w.tile(1), w.bst(), w.ws,
                    w.npairs, two, bt_ok, scale, x, w.ypub() + par,
                    w.vpart());
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();  // every panel's rows are published
  for (int i = threadIdx.x; i < w.p; i += DN_WIDE_THREADS)
    y[i] = cl.map_shared_rank(w.ypub(), i / R)[par + i % R];
  __syncthreads();
}

// This block's pairs of B^2 of the normalised Gram: Bn Bn = sum over B's
// rows k of Bn[k][I] Bn[k][J], B's rows read across the cluster (down a
// column of the pair that holds them, or of its B^T) and staged DN_PCL_BT
// at a time in tile 1, then each pair into B^2 (tile 1 where a block holds
// one pair, else the workspace); ends with a cluster barrier (B^2
// published).  `tr` (the blocks share the power step): each off-diagonal
// pair's transpose too, swizzled as B^T's, for reads down its columns: in
// the workspace after B^T's, from the register tile, or where a block holds
// one pair in B^T's place once every block is done reading B (one more
// cluster barrier), from the register tile or (T_SMEM) from B^2's pair in
// the second tile.  (Kernel 2 takes T_SMEM, kernel 4 not: the other way
// each spilled registers; kernel 4 shares the power step only where a block
// holds several pairs.)  TR: `tr` may be true (kernels 1 and 3 compile no
// transposes).  Compiled once a (TR, T_SMEM), out of line, with its own
// register tile (its reads across the cluster beside a kernel's own
// registers spilled), so its arguments are values: the block's shared
// memory S (PclWork) and the cluster's workspace.
template <bool TR, bool T_SMEM>
static __device__ __noinline__ void pcl_square(int p, int T, int C, int rank,
                                               int held, int npairs,
                                               float* S, float* ws,
                                               float inv, bool tr) {
  constexpr int BT = DN_PCL_BT, LD = DN_PANEL_LD, R = DN_PANEL_ROWS;
  cg::cluster_group cl = cg::this_cluster();
  const int t = threadIdx.x, kk = t & (BT - 1), r0 = (t / BT) * (R / 8);
  float* SI = S + DN_PCL_PAIR;
  float* SJ = SI + BT * LD;
  // (PclWork::pair and pair_t of B, from values)
  const auto pair = [&](int e) -> const float* {
    if (ws != nullptr) return ws + (size_t)e * DN_PCL_PAIR;
    return cl.map_shared_rank(S, e);
  };
  const auto pair_t = [&](int e) -> const float* {
    if (ws != nullptr)
      return ws + (size_t)2 * npairs * DN_PCL_PAIR + (size_t)e * R * R;
    return cl.map_shared_rank(S + 2 * DN_PCL_PAIR, e);
  };
  // B^2's transpose of pair e from the register tile, as pcl_store's B^T
  const auto store_t = [&](const WideGram<128>& gg, float* Bt) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int s2 = 0; s2 < 8; ++s2) {
        const int jj = gg.tx * 8 + s2, ii = gg.ty * 8 + r;
        Bt[jj * R + (ii ^ (jj >> 3))] = gg.acc[r][s2];
      }
  };
  WideGram<128> g;
  bool off = false;  // this block's last pair is off the diagonal
  for (int h = 0; h < held; ++h) {
    const int e = rank + h * C;
    if (e >= npairs) break;
    int I, J;
    dn_pcl_pair(T, e, I, J);
    const int nb = I == J ? 1 : 2;
    off = I != J;
    g.zero();
    for (int k0 = 0; k0 < p; k0 += BT) {
      const int k = k0 + kk, K = k / R, kr = k % R;
      for (int pn = 0; pn < nb; ++pn) {
        const int P = pn ? J : I;
        float* Sk = (pn ? SJ : SI) + kk * LD + r0;
        // B[i][k] for rows i of panel P: pair (P, K) along a row (a warp
        // on consecutive k), or B^T of pair (K, P)
        const float* bp =
            K < P ? pair_t(dn_pcl_index(T, K, P)) : pair(dn_pcl_index(T, P, K));
#pragma unroll
        for (int k4 = 0; k4 < R / 8; k4 += 4) {
          float x4[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int ip = r0 + k4 + jj, i = P * R + ip;
            const float b = K < P ? bp[ip * R + (kr ^ (ip >> 3))]
                                  : bp[ip * LD + kr];
            x4[jj] = (k < p && i < p) ? b * inv : 0.f;
          }
          wide_st<4>(Sk + k4, x4);
        }
      }
      __syncthreads();
      g.syrk2<LD>(SI, nb == 2 ? SJ : SI, BT);
      __syncthreads();
    }
    g.store(ws != nullptr ? ws + (size_t)(npairs + e) * DN_PCL_PAIR : SI);
    if (TR && tr && off && ws != nullptr)
      store_t(g, ws + (size_t)2 * npairs * DN_PCL_PAIR +
                     (size_t)(npairs + e) * R * R);
  }
  cl.sync();
  if (TR && tr && ws == nullptr) {
    // every block has read B^T: its place takes B^2's
    if (off && !T_SMEM) store_t(g, S + 2 * DN_PCL_PAIR);
    if (off && T_SMEM) {
      float* Bt = S + 2 * DN_PCL_PAIR;
      for (int k = t; k < R * R; k += DN_WIDE_THREADS) {
        const int jj = k / R, ii = k % R;
        Bt[jj * R + (ii ^ (jj >> 3))] = SI[ii * LD + jj];
      }
    }
    cl.sync();
  }
}

// The power step on the cluster's B (published, largest entry bmax), from
// u to the refit u, as panel_refit: every block runs it on the same
// numbers, so u and s are the same in every block.  SHARE: pcl_matvec's;
// T_SMEM: pcl_square's.
template <bool SHARE = false, bool T_SMEM = false, class A>
__device__ __forceinline__ void pcl_refit(PclWork<A>& w, float bmax,
                                          int n_squared, int n_plain,
                                          bool finish, float& s) {
  const float inv = 1.0f / (bmax + DN_EPS);
  if (n_plain > 0) {
    const float* x = w.u();
    for (int it = 0; it < n_plain; ++it) {
      float* y = (it & 1) ? w.vb() : w.va();
      pcl_matvec<SHARE>(w, false, inv, x, y);
      x = y;
    }
    panel_renormalize(w.red(), w.p, x, w.u());
  } else {
    pcl_square<SHARE, T_SMEM>(w.p, w.T, w.C, w.rank, w.held, w.npairs, w.S,
                              w.ws, inv, SHARE && w.shared);
    int n_bodies = n_squared / 4;
    if (n_bodies < 1) n_bodies = 1;
    for (int it = 0; it < n_bodies; ++it) {
      pcl_matvec<SHARE>(w, true, 1.f, w.u(), w.va());
      pcl_matvec<SHARE>(w, true, 1.f, w.va(), w.vb());
      panel_renormalize(w.red(), w.p, w.vb(), w.u());
    }
  }
  if (finish) {
    // (B^T's place holds B^2's where the blocks share the power step and a
    // block holds one pair)
    pcl_matvec<SHARE>(w, false, 1.f, w.u(), w.va(),
                      n_plain > 0 || !w.shared || w.ws != nullptr);
    float ubu = 0.f;
    for (int j = threadIdx.x; j < w.p; j += DN_WIDE_THREADS)
      ubu = fmaf(w.u()[j], w.va()[j], ubu);
    s = sqrtf(fmaxf(panel_sum(w.red(), ubu), 0.f));
  }
}

// The whole Lagrangian NMF-OA loop of one gene by its cluster, as
// wide.cuh's wide_core (its ADAPT and from_x branches and results), X in
// w.X: every
// block calls it with the same gene, u starts in each block's u() and comes
// back refit there, the same in every block (SHARE: see pcl_matvec, kernel
// 4, whose blocks share the power step past T = 5); E is stored by block 0
// (visible to the cluster on return).  `src` as wide_core's, but for X.
// Returns this thread's share of sum_w E[w], the same in every block.
template <bool ADAPT, bool SHARE = false, class Src, class A>
__device__ __forceinline__ float pcl_core(const Src& src, PclWork<A>& w,
                                          float& s, int nmf_iter,
                                          int power_cold, int power_warm,
                                          int warm_plain, float tol = 0.f,
                                          int* n_run = nullptr,
                                          bool from_x = false) {
  constexpr int TC = DN_WIDE_TC;
  const int t = threadIdx.x, q = t >> 6, c = t & (TC - 1);
  const float step =
      nmf_iter > 0 ? (float)(1.0 / sqrt((double)nmf_iter)) : 0.f;
  WideGram<128> g;
  s = 0.f;
  float bmax = pcl_sweep<ADAPT, false>(src, w, g, step, s, from_x);
  pcl_refit<SHARE>(w, bmax, power_cold, 0, ADAPT || nmf_iter == 0, s);

  int ran = nmf_iter;
  for (int it = 0; it < nmf_iter; ++it) {
    bmax = pcl_sweep<ADAPT, true>(src, w, g, step, s, false);
    if constexpr (ADAPT) {
      const float s_old = s;
      for (int i = t; i < w.np; i += DN_WIDE_THREADS) w.uo()[i] = w.u()[i];
      __syncthreads();
      pcl_refit<SHARE>(w, bmax, power_warm, warm_plain, true, s);
      float delta = 0.f, ref = 0.f;
      for (int j = t; j < w.p; j += DN_WIDE_THREADS) {
        const float k_new = __fmul_rn(w.u()[j], s);
        delta = fmaxf(delta, fabsf(k_new - __fmul_rn(w.uo()[j], s_old)));
        ref = fmaxf(ref, fabsf(k_new));
      }
      delta = panel_max(w.red(), delta);
      ref = fmaxf(panel_max(w.red(), ref), DN_EPS);
      if (delta <= __fmul_rn(tol, ref)) {  // frozen: this update kept
        ran = it + 1;
        break;
      }
    } else {
      pcl_refit<SHARE>(w, bmax, power_warm, warm_plain, it == nmf_iter - 1,
                       s);
    }
  }
  if (n_run != nullptr) *n_run = ran;

  // finish: E = X^T u / (s + eps), each panel's partial from the X its
  // diagonal block wrote back
  const int ntile = (src.n_local() + TC - 1) / TC;
  float se = 0.f;
  for (int k = 0; k < ntile; ++k) {
    const int l = k * TC + c;
    const bool on = src.on(l);
    float e = 0.f;
    if (__syncthreads_or(on)) {
      const float v =
          pcl_v(w, on, w.X + (size_t)l * w.ldx + w.I * DN_PANEL_ROWS);
      if (on) e = v / (s + DN_EPS);
    }
    if (q == 0) {
      if (w.rank == 0) src.store_e(l, e);
      se += e;
    }
  }
  cg::this_cluster().sync();  // E is visible to the cluster
  return se;
}

// The launch of a cluster kernel at p, as launch_pcl makes it (dn_pcl_size(p)
// blocks a cluster, a non-portable size asked for as such past
// DN_PCL_PORTABLE, `smem_floats` floats of dynamic shared memory a block),
// and the clusters the card holds at once (cudaOccupancyMaxActiveClusters)
// into `fit`.  Returns the CUDA error, 0 on success.
template <class Kern>
int pcl_occupancy(Kern kern, int p, size_t smem_floats,
                  cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                  int& fit) {
  const int C = dn_pcl_size(p);
  const size_t dyn = sizeof(float) * smem_floats;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (e != cudaSuccess) return (int)e;
  if (C > DN_PCL_PORTABLE) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cfg = {};
  cfg.gridDim = dim3((unsigned)C, 1, 1);
  cfg.blockDim = dim3(DN_WIDE_THREADS, 1, 1);
  cfg.dynamicSmemBytes = dyn;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  fit = 0;
  return (int)cudaOccupancyMaxActiveClusters(&fit, (const void*)kern, &cfg);
}

// Launch of a cluster kernel of `kind` (DN_PCL_LOOP or DN_PCL_STREAM) at p:
// pcl_occupancy's launch, as many clusters as the card holds at once (at
// most G, and at most `slots` where its blocks hold several pairs: the
// workspace's), each working through the genes blockIdx.x / C, + gridDim.x
// / C, ...  A p outside the kind's cluster layout, or a cluster the card
// cannot hold, is an error, never a fallback.  Returns the CUDA error, 0 on
// success.
template <class Kern, class... Args>
int launch_pcl(Kern kern, int kind, int G, int p, int slots,
               size_t smem_floats, cudaStream_t st, Args... args) {
  if (!dn_pcl_on(p, kind)) return (int)cudaErrorInvalidValue;
  if (G == 0) return 0;
  const int C = dn_pcl_size(p);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int fit = 0;
  cudaError_t e = (cudaError_t)pcl_occupancy(kern, p, smem_floats, cfg, attr,
                                             fit);
  if (e != cudaSuccess) return (int)e;
  if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  if (dn_pcl_held(p) > 1) {
    if (slots < 1) return (int)cudaErrorInvalidValue;
    if (fit > slots) fit = slots;
  }
  cfg.gridDim = dim3((unsigned)((G < fit ? G : fit) * C), 1, 1);
  cfg.stream = st;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
