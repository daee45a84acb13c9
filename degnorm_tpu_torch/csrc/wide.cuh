// Shared device code of the DegNorm CUDA kernels for 33 <= p <= 128 samples
// (sm_90a, plain float32): the Lagrangian NMF-OA loop of one gene with the
// p x p Gram in shared memory and the power step run by the whole block.
//
// Replaces, for wide studies, the helpers of common.cuh (nmf_core, WarpGram,
// power_refit) that kernels 1, 3 and 4 share, and so the same TPU code:
// degnorm_tpu/ops/pallas_nmf.py (_gram, _power, _power_warm, _nmf_loop),
// which ops/pallas_trim.py and ops/pallas_stream.py use the same way.  The
// TPU kernels have no cap on p; common.cuh's layout stops at 32, because a
// thread owns whole columns with x[PMAX] in registers, a warp's lane i holds
// row i of the Gram for the power step, and the PMAX = 32 instances already
// sit at 255 registers.
//
// The layout here (a block-level SYRK, chosen over rows in chunks of 32 on
// common.cuh's column-a-thread layout because the Gram's p(p+1)/2 products
// a column dominate everything else a sweep does at p > 32, and a register
// tile of the Gram reuses each staged value R times where per-warp
// accumulators in shared memory would reload it for every product).  A
// block is 256 threads; a sweep goes over the gene's columns in tiles of
// DN_WIDE_TC = 64, of one of two kinds, chosen by where the gene's columns
// come from (the source's PIPE), each the faster on its genes
// (tools/wide_core_ab.py):
//   * the synchronous sweep (wide_sweep_sync: the resident kernels 1 and 3,
//     whose genes have a few tiles a sweep, too few to fill a pipeline, and
//     kernel 4 at PMAX = 128, where the pipelined sweep spilled registers):
//     thread (q = t / 64, c = t % 64) loads rows q Q .. q Q + Q - 1 (Q =
//     PMAX / 4) of column c, its X into the tile S and its A0 into a second
//     tile, UG groups of four rows in flight, sums its partial of v_c with
//     the other quarters' in a fixed order and updates S in place; then
//     thread (ty = t / 16, tx = t % 16) adds S to its R x R block (R = PMAX
//     / 16) of the full Gram in registers (WideGram, both triangles, equal
//     bit for bit);
//   * the pipelined sweep (wide_sweep: kernel 4's streamed genes at PMAX <=
//     96, dozens of tiles a block), two roles.  The tile threads (warps 4-7)
//     bring tile k + NST's rows of X and A0 into a copy stage in shared
//     memory as they are stored (cp.async, 16 bytes a copy; int16 stays
//     int16, divided on its way into the tile) while they work on tile k: v
//     over two quarters a thread, the update (X written back to device
//     memory), the tile into one of two buffers S, handed to the gram
//     threads by named barriers (full, and empty back); a tile with no
//     active column is not copied.
//     The gram threads (warps 0-3) take the Gram's upper triangle only
//     (WideTri): over the 16 x 16 grid of R x R blocks, one off-diagonal
//     block a thread for 120 of them, two diagonal blocks for the other 8,
//     the same R x R products and row loads a column for every thread (no
//     warp diverges); the odd diagonal blocks' diagonals are summed by 64
//     tile threads (WideDiag).  Every entry gets the products the full tile
//     gives it, in the same order, and is mirrored, so B has the full
//     Gram's bits, from half its fmas;
//   * a tile with no active column adds nothing to the Gram and is skipped,
//     which is exact;
//   * after a sweep the Gram goes into B in shared memory (kernel 4: its
//     cluster's blocks sum their partials in rank order through distributed
//     shared memory), and the power step is the block's: B's largest entry
//     by a block reduction, B^2 of the squared scheme as a register tile
//     again (Bn Bn = sum_k Bn[k] Bn[k]^T), each matvec a register tile times
//     a vector in shared memory, reduced over the 16 threads of a half-warp
//     with a fixed xor butterfly, and every norm and dot product summed by
//     each thread itself in one fixed order, so u is bit-equal across the
//     block, the cluster and two runs.
//
// What bounds it on this card: float32 operations, p(p+1) a column a sweep
// for the Gram (the synchronous sweep computes p^2: both triangles),
// against 4p bytes of X read and written and 2p or 4p of A0 read a sweep;
// a streamed gene's X round trip through device memory sets the floor of
// kernel 4 at p <= 64, and the pipeline's copies overlap it with the gram
// threads' fmas.  Rows p..PMAX-1 are carried as zeros (PMAX in {48, 64, 96,
// 128}), which is exact.
//
// Shared memory (floats, rows of LD = PMAX + 4, 16-byte aligned, so that a
// quarter-warp's float4 stores into S are conflict-free): S (TC rows), B
// (PMAX rows), the v partials (4 x TC), five p-vectors and 32 floats of
// scratch (wide_core_floats), the second buffer S1 (TC rows;
// wide_sync_floats: the synchronous sweep, 54,656 bytes at PMAX = 64),
// then eight flags and the copy stage (NST slots of PMAX x TC floats of X
// and as many of A0; wide_work_floats: the pipelined sweep, 87,456 bytes at
// PMAX = 64 with one slot), dynamic shared memory sized at launch
// (cudaFuncSetAttribute above 48 KB).
//
// Kept from common.cuh: sums in a fixed order and no float atomics; plain
// FP32 (no TF32 or bf16 Gram); a thread keeps a 64-bit mask of its active
// column slots (slot k: its column of tile k) from the cold sweep on; no
// -use_fast_math.
#pragma once

#include <type_traits>

#include "common.cuh"

#define DN_WIDE_THREADS 256
#define DN_WIDE_TC 64      // columns of a tile
#define DN_WIDE_MIN_P 33   // below this the common.cuh instances run

template <int PMAX>
struct WideShape {
  static_assert(PMAX % 16 == 0 && PMAX <= 128, "PMAX: 48, 64, 96 or 128");
  static constexpr int R = PMAX / 16;  // Gram block a thread (R x R)
  static constexpr int Q = PMAX / 4;   // rows a thread in a tile's update
  static constexpr int LD = PMAX + 4;  // floats a row of S and B
  // the synchronous sweep's groups of four rows whose loads are issued
  // together: all of them where the registers allow (PMAX 48 and 96), two
  // at PMAX 64 (two blocks an SM fit 128 registers a thread) and 128
  static constexpr int UG = (PMAX == 48 || PMAX == 96) ? Q / 4 : 2;
  // slots of the copy stage (kernel 4's pipelined sweep): two at PMAX 48
  // (the next tile's copy in flight while one tile is worked on), else one
  static constexpr int NST = PMAX <= 48 ? 2 : 1;
};

// Blocks an SM named in the launch bounds of kernels 1 and 2: two at PMAX
// <= 64 (they then fit 128 registers a thread), else one (up to 255).
// Kernel 3 names one at every PMAX: its own state spilled at 128.
template <int PMAX>
__host__ __device__ constexpr int dn_wide_min_blocks() {
  return PMAX <= 64 ? 2 : 1;
}

// ... and in those of kernel 4: two at PMAX <= 64 too, where its pipelined
// sweep (four warps on the Gram) needs the second block's warps
template <int PMAX>
__host__ __device__ constexpr int dn_wide_core_blocks() {
  return PMAX <= 64 ? 2 : 1;
}

// Floats of the core's shared memory (WideWork) without the second tile
// buffer and the copy stage, which only the sweeps of wide_core use ...
template <int PMAX>
__host__ __device__ constexpr int wide_core_floats() {
  return DN_WIDE_TC * WideShape<PMAX>::LD + PMAX * WideShape<PMAX>::LD +
         4 * DN_WIDE_TC + 5 * PMAX + 32;
}

// ... with the second tile buffer (the synchronous sweep's A0 tile:
// kernels 1 and 3) ...
template <int PMAX>
__host__ __device__ constexpr int wide_sync_floats() {
  return wide_core_floats<PMAX>() + DN_WIDE_TC * WideShape<PMAX>::LD;
}

// ... and with the copy stage too (the pipelined sweep: kernel 4).
template <int PMAX>
__host__ __device__ constexpr int wide_work_floats() {
  return wide_sync_floats<PMAX>() + 8 +
         2 * WideShape<PMAX>::NST * PMAX * DN_WIDE_TC;
}

// The core's shared memory, carved from a 16-byte aligned base.
template <int PMAX>
struct WideWork {
  float* S;      // TC x LD: a tile's columns, rows contiguous (buffer 0)
  float* S1;     // TC x LD: buffer 1 (the synchronous sweep's A0 tile)
  float* B;      // PMAX x LD: the gene's Gram
  float* vpart;  // 4 x TC: the quarters' partials of v
  float* u;      // PMAX: the left vector (zero beyond p)
  float* va;     // PMAX: matvec results
  float* vb;
  float* vc;
  float* uo;     // PMAX: the previous u (ADAPT)
  float* red;    // 32: block reductions
  int* flag;     // 8: whether a warp's columns of tile k are active (at
                 // 2 (k % 4) and 2 (k % 4) + 1: a ring of four tiles)
  float* stx;    // NST x PMAX x TC: the copy stage, a tile's X rows as
                 // stored a slot ...
  float* sta;    // ... and its A0 rows (float32, or int16)
  __device__ __forceinline__ void init(float* base) {
    constexpr int LD = WideShape<PMAX>::LD;
    S = base;
    B = S + DN_WIDE_TC * LD;
    vpart = B + PMAX * LD;
    u = vpart + 4 * DN_WIDE_TC;
    va = u + PMAX;
    vb = va + PMAX;
    vc = vb + PMAX;
    uo = vc + PMAX;
    red = uo + PMAX;
    S1 = red + 32;  // from here on: a launch without them ends before
    flag = (int*)(S1 + DN_WIDE_TC * LD);
    stx = S1 + DN_WIDE_TC * LD + 8;
    sta = stx + WideShape<PMAX>::NST * PMAX * DN_WIDE_TC;
  }
  __device__ __forceinline__ float* Sb(int b) const { return b ? S1 : S; }
  // tile k holds an active column (the tile threads' vote)
  __device__ __forceinline__ bool active(int k) const {
    return (flag[2 * (k & 3)] | flag[2 * (k & 3) + 1]) != 0;
  }
};

// R consecutive floats of shared memory (16-byte aligned where R % 4 == 0,
// 8-byte where R % 2 == 0) into registers.
template <int R>
__device__ __forceinline__ void wide_ld(const float* p, float (&a)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int k = 0; k < R; k += 4) {
      const float4 v = *(const float4*)(p + k);
      a[k] = v.x;
      a[k + 1] = v.y;
      a[k + 2] = v.z;
      a[k + 3] = v.w;
    }
  } else if constexpr (R % 2 == 0) {
#pragma unroll
    for (int k = 0; k < R; k += 2) {
      const float2 v = *(const float2*)(p + k);
      a[k] = v.x;
      a[k + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) a[k] = p[k];
  }
}

// Q floats of registers into shared memory at p (16-byte aligned: Q and the
// row offsets q Q are multiples of 4 at every PMAX).
template <int Q>
__device__ __forceinline__ void wide_st(float* p, const float (&a)[Q]) {
  static_assert(Q % 4 == 0, "rows a quarter: a multiple of 4");
#pragma unroll
  for (int k = 0; k < Q; k += 4)
    *(float4*)(p + k) = make_float4(a[k], a[k + 1], a[k + 2], a[k + 3]);
}

// The thread's R x R block of the Gram, and its place in it.
template <int PMAX>
struct WideGram {
  static constexpr int R = WideShape<PMAX>::R, LD = WideShape<PMAX>::LD;
  float acc[R][R];
  int ty, tx;
  __device__ __forceinline__ WideGram()
      : ty(threadIdx.x >> 4), tx(threadIdx.x & 15) {}
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int s = 0; s < R; ++s) acc[r][s] = 0.f;
  }
  // acc += sum over the n rows k of M (rows of LD floats) of
  // (scale M[k][ty R + r]) (scale M[k][tx R + s]); scale == 1 exactly skips
  // the products (the sweeps' tiles)
  template <bool SCALED>
  __device__ __forceinline__ void syrk_row(const float* Mk, float scale) {
    float a[R], b[R];
    wide_ld<R>(Mk + ty * R, a);
    wide_ld<R>(Mk + tx * R, b);
    if constexpr (SCALED) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        a[r] *= scale;
        b[r] *= scale;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int s = 0; s < R; ++s) acc[r][s] = fmaf(a[r], b[s], acc[r][s]);
  }
  // (four rows of loads in flight for small blocks, two for the R = 6, 8
  // blocks, whose registers are shorter)
  template <bool SCALED>
  __device__ __forceinline__ void syrk(const float* M, int n, float scale) {
    if constexpr (R <= 4) {
#pragma unroll 4
      for (int k = 0; k < n; ++k) syrk_row<SCALED>(M + k * LD, scale);
    } else {
#pragma unroll 2
      for (int k = 0; k < n; ++k) syrk_row<SCALED>(M + k * LD, scale);
    }
  }
  // acc += sum over the n rows k of MI and MJ (rows of LD floats) of
  // MI[k][ty R + r] MJ[k][tx R + s]: one panel pair of panel.cuh (MJ == MI
  // is syrk's unscaled sum, the same products in the same order)
  template <int LDM>
  __device__ __forceinline__ void syrk2(const float* MI, const float* MJ,
                                        int n) {
#pragma unroll 2
    for (int k = 0; k < n; ++k) {
      float a[R], b[R];
      wide_ld<R>(MI + k * LDM + ty * R, a);
      wide_ld<R>(MJ + k * LDM + tx * R, b);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int s = 0; s < R; ++s) acc[r][s] = fmaf(a[r], b[s], acc[r][s]);
    }
  }
  // B[ty R + r][tx R + s] = acc[r][s]
  __device__ __forceinline__ void store(float* B) const {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int s = 0; s < R; ++s) B[(ty * R + r) * LD + tx * R + s] = acc[r][s];
  }
  // acc = scale * B's block
  __device__ __forceinline__ void load(const float* B, float scale) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float b[R];
      wide_ld<R>(B + (ty * R + r) * LD + tx * R, b);
#pragma unroll
      for (int s = 0; s < R; ++s) acc[r][s] = b[s] * scale;
    }
  }
  // y = acc x over the whole matrix: each thread its R rows' partial over
  // its R columns, summed over the 16 threads of its half-warp (tx) with a
  // fixed xor butterfly (every lane ends with the same bits); tx == 0
  // writes.  Ends with a barrier: y is visible to the block.
  __device__ __forceinline__ void matvec(const float* x, float* y) const {
    float xs[R];
    wide_ld<R>(x + tx * R, xs);
    float part[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float v = 0.f;
#pragma unroll
      for (int s = 0; s < R; ++s) v = fmaf(acc[r][s], xs[s], v);
#pragma unroll
      for (int o = 8; o >= 1; o >>= 1) v += __shfl_xor_sync(DN_FULL, v, o);
      part[r] = v;
    }
    if (tx == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) y[ty * R + r] = part[r];
    }
    __syncthreads();
  }
};

// The largest |B[i][j]|, the same in every thread.  Starts and ends with a
// barrier of its own use of `red`.
template <int PMAX>
__device__ __forceinline__ float wide_absmax(const WideWork<PMAX>& w) {
  constexpr int LD = WideShape<PMAX>::LD;
  float m = 0.f;
  for (int k = threadIdx.x; k < PMAX * PMAX; k += DN_WIDE_THREADS)
    m = fmaxf(m, fabsf(w.B[(k / PMAX) * LD + k % PMAX]));
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) w.red[threadIdx.x >> 5] = m;
  __syncthreads();
  float r = w.red[0];
#pragma unroll
  for (int k = 1; k < DN_WIDE_THREADS / 32; ++k) r = fmaxf(r, w.red[k]);
  __syncthreads();
  return r;
}

// u = wv / |wv|, keeping u where the update collapsed; wv visible.  Each of
// the PMAX writers sums the norm itself in one order.  Ends with a barrier.
template <int PMAX>
__device__ __forceinline__ void wide_renormalize(const float* wv, float* u) {
  const int t = threadIdx.x;
  if (t < PMAX) {
    float n2 = 0.f;
#pragma unroll 8
    for (int j = 0; j < PMAX; ++j) n2 = fmaf(wv[j], wv[j], n2);
    const float nrm = sqrtf(n2);
    if (nrm > DN_EPS) u[t] = wv[t] / (nrm + DN_EPS);
  }
  __syncthreads();
}

// s = sqrt(max(u^T B u, 0)), the same in every thread.  Ends with a barrier.
template <int PMAX>
__device__ __forceinline__ float wide_scale(const WideWork<PMAX>& w) {
  constexpr int LD = WideShape<PMAX>::LD;
  const int t = threadIdx.x;
  if (t < PMAX) {
    float bu = 0.f;
#pragma unroll 8
    for (int j = 0; j < PMAX; ++j) bu = fmaf(w.B[t * LD + j], w.u[j], bu);
    w.vc[t] = bu;
  }
  __syncthreads();
  float ubu = 0.f;
#pragma unroll 8
  for (int j = 0; j < PMAX; ++j) ubu = fmaf(w.u[j], w.vc[j], ubu);
  __syncthreads();
  return sqrtf(fmaxf(ubu, 0.f));
}

// The power step on the gene's Gram in w.B (visible), from the u in w.u to
// the refit one in w.u: n_plain > 0 plain matvecs on the normalised Gram and
// one normalisation, else the squared scheme, max(1, n_squared / 4) bodies
// of two B^2 applications; with `finish`, s = sqrt(max(u^T B u, 0)) too.
// The register tile `g` is overwritten.  Every thread returns the same s.
template <int PMAX>
__device__ __forceinline__ void wide_refit(WideWork<PMAX>& w, WideGram<PMAX>& g,
                                           int n_squared, int n_plain,
                                           bool finish, float& s) {
  const float inv = 1.0f / (wide_absmax<PMAX>(w) + DN_EPS);
  if (n_plain > 0) {
    g.load(w.B, inv);  // Bn = B / (max|B| + eps), one reciprocal
    const float* x = w.u;
    for (int it = 0; it < n_plain; ++it) {
      float* y = (it & 1) ? w.vb : w.va;
      g.matvec(x, y);
      x = y;
    }
    wide_renormalize<PMAX>(x, w.u);
  } else {
    g.zero();
    g.template syrk<true>(w.B, PMAX, inv);  // B^2 of the normalised Gram
    int n_bodies = n_squared / 4;
    if (n_bodies < 1) n_bodies = 1;
    for (int it = 0; it < n_bodies; ++it) {
      g.matvec(w.u, w.va);
      g.matvec(w.va, w.vb);
      wide_renormalize<PMAX>(w.vb, w.u);
    }
  }
  if (finish) s = wide_scale<PMAX>(w);
}

// ---- the sweeps: two roles a block ----------------------------------------
// Warps 0-3 (the gram threads) accumulate the Gram's upper triangle in
// registers (WideTri); warps 4-7 (the tile threads) bring each tile in
// through the copy stage, compute v and the multiplier update and hand the
// tile over in one of two shared-memory buffers.  Named barriers hand the
// buffers over (0 is __syncthreads).
#define DN_WIDE_GRAM_THREADS 128
#define DN_WIDE_TILE_THREADS (DN_WIDE_THREADS - DN_WIDE_GRAM_THREADS)
#define DN_WIDE_TRI_PAIRS 120  // off-diagonal R x R blocks of the 16 x 16 grid
#define DN_BAR_FULL 1          // + b: buffer b holds a staged tile
#define DN_BAR_EMPTY 3         // + b: the gram threads are done with buffer b
#define DN_BAR_TILE 5          // the tile threads alone

__device__ __forceinline__ void dn_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void dn_bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}
// 16 bytes from device memory into shared memory through the copy engine
__device__ __forceinline__ void dn_cp_async16(void* smem, const void* gmem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(a),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void dn_cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void dn_cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// A gram thread's share of the Gram's upper triangle over a 16 x 16 grid of
// R x R blocks: thread g < 120 the off-diagonal block (I, J), I < J, in
// row order; thread 120 + d the two diagonal blocks 2d and 2d + 1, the
// upper triangle of the first (with its diagonal) at r <= s of its tile,
// the upper triangle of the second at r > s, transposed.  Every thread
// issues the same instructions (R x R products of four rows of R values a
// column), so no warp diverges; the diagonal of the odd blocks is the tile
// threads' (WideDiag).  Each entry gets the products of wide.cuh's full
// register tile in the same order (an fma's two factors commute exactly),
// so B, mirrored, has the bits of the full Gram.
template <int PMAX>
struct WideTri {
  static constexpr int R = WideShape<PMAX>::R, LD = WideShape<PMAX>::LD;
  float acc[R][R];
  int a1, b1, a2, b2;  // first rows in a tile of A1, B1, A2, B2
  bool diag;
  __device__ __forceinline__ explicit WideTri(int g) {
    if (g < DN_WIDE_TRI_PAIRS) {
      int I = 0, rem = g;
      while (rem >= 15 - I) {
        rem -= 15 - I;
        ++I;
      }
      a1 = a2 = I * R;
      b1 = b2 = (I + 1 + rem) * R;
      diag = false;
    } else {
      const int d = 2 * (g - DN_WIDE_TRI_PAIRS);
      a1 = b1 = d * R;
      a2 = b2 = (d + 1) * R;
      diag = true;
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int s = 0; s < R; ++s) acc[r][s] = 0.f;
  }
  __device__ __forceinline__ void syrk_row(const float* Mk) {
    constexpr int H = R % 4 == 0 ? 4 : R;  // rows of A1 and A2 a load
    float B1[R], B2[R];
    wide_ld<R>(Mk + b1, B1);
    wide_ld<R>(Mk + b2, B2);
#pragma unroll
    for (int r0 = 0; r0 < R; r0 += H) {
      float A1[H], A2[H];
      wide_ld<H>(Mk + a1 + r0, A1);
      wide_ld<H>(Mk + a2 + r0, A2);
#pragma unroll
      for (int rr = 0; rr < H; ++rr)
#pragma unroll
        for (int s = 0; s < R; ++s) {
          const int r = r0 + rr;
          acc[r][s] = r > s ? fmaf(A2[rr], B2[s], acc[r][s])
                            : fmaf(A1[rr], B1[s], acc[r][s]);
        }
    }
  }
  // acc += the n rows (columns of the gene) of the tile M: two columns in
  // flight at R = 3, one at R >= 4 (at PMAX 64, two blocks an SM and 128
  // registers a thread, two spilled; tools/wide_core_ab.py)
  __device__ __forceinline__ void syrk(const float* M, int n) {
#pragma unroll (R == 3 ? 2 : 1)
    for (int k = 0; k < n; ++k) syrk_row(M + k * LD);
  }
  // the Gram entry (i, j), i <= j, that acc[r][s] holds
  __device__ __forceinline__ void entry(int r, int s, int& i, int& j) const {
    if (!diag) {
      i = a1 + r;
      j = b1 + s;
    } else if (r <= s) {
      i = a1 + r;
      j = a1 + s;
    } else {
      i = a2 + s;
      j = a2 + r;
    }
  }
  // acc into B and its mirror
  __device__ __forceinline__ void store(float* B) const {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int s = 0; s < R; ++s) {
        int i, j;
        entry(r, s, i, j);
        B[i * LD + j] = acc[r][s];
        B[j * LD + i] = acc[r][s];
      }
  }
};

// The diagonal entries of the odd R x R blocks: tile thread tt < PMAX / 2
// sums its row's squares over a tile's columns in order, as the full tile
// did.
template <int PMAX>
struct WideDiag {
  static constexpr int R = WideShape<PMAX>::R, LD = WideShape<PMAX>::LD;
  float acc = 0.f;
  int row = -1;  // -1: no entry
  __device__ __forceinline__ explicit WideDiag(int tt) {
    if (tt >= 0 && tt < PMAX / 2) row = ((tt / R) * 2 + 1) * R + tt % R;
  }
  __device__ __forceinline__ void syrk(const float* M, int n) {
    if (row < 0) return;
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      const float x = M[k * LD + row];
      acc = fmaf(x, x, acc);
    }
  }
};

// The pipelined sweep's Gram of a block: the triangle and its mirror, and
// the odd diagonal blocks' diagonals, into w.B.  Ends with a barrier.
template <int PMAX>
__device__ __forceinline__ void wide_tri_store(const WideTri<PMAX>& tri,
                                               const WideDiag<PMAX>& dg,
                                               WideWork<PMAX>& w) {
  constexpr int LD = WideShape<PMAX>::LD;
  if (threadIdx.x < DN_WIDE_GRAM_THREADS) tri.store(w.B);
  if (dg.row >= 0) w.B[dg.row * LD + dg.row] = dg.acc;
  __syncthreads();
}

// The reduction of a block that owns a whole gene (the synchronous sweep's
// full register tile): its Gram block goes to w.B.  (Kernel 4's cluster
// has its own: stream_wide.cuh.)
struct WideBlockRed {
  template <int PMAX>
  __device__ __forceinline__ void reduce(WideGram<PMAX>& g,
                                         WideWork<PMAX>& w) const {
    g.store(w.B);
    __syncthreads();
  }
};

// One tile into a slot of the copy stage (tile threads, tt their index):
// the X rows (want_x) and the A0 rows (want_a) of columns l0 .. l0 + 63, as
// they are stored (int16 stays int16).  16-byte cp.async copies where the
// rows are 16-byte aligned (Src::vec()), else plain loads; columns past the
// gene's last are not copied (their slots are off).  The caller commits.
template <int PMAX, class Src>
__device__ __forceinline__ void wide_stage(const Src& src, WideWork<PMAX>& w,
                                           int p, int l0, int slot,
                                           bool want_x, bool want_a, int tt) {
  constexpr int TC = DN_WIDE_TC, NT = DN_WIDE_TILE_THREADS;
  using A = typename Src::AType;
  constexpr int AV = 16 / sizeof(A);  // A0 elements a copy
  const int valid = src.valid_cols(l0);
  float* stx = w.stx + slot * PMAX * TC;
  A* sta = (A*)w.sta + slot * PMAX * TC;
  if (src.vec()) {
    const auto cp_x = [&](int k) {
      const int i = k / (TC / 4), j = (k % (TC / 4)) * 4;
      if (j < valid) dn_cp_async16(stx + i * TC + j, src.xrow(i, l0) + j);
    };
    const auto cp_a = [&](int k) {
      const int i = k / (TC / AV), j = (k % (TC / AV)) * AV;
      if (j < valid) dn_cp_async16(sta + i * TC + j, src.arow(i, l0) + j);
    };
    if constexpr (dn_wide_core_blocks<PMAX>() == 2) {
      // not unrolled at two blocks an SM (128 registers a thread): the
      // unrolled copies' addresses spilled
      if (want_x)
#pragma unroll 1
        for (int k = tt; k < p * (TC / 4); k += NT) cp_x(k);
      if (want_a)
#pragma unroll 1
        for (int k = tt; k < p * (TC / AV); k += NT) cp_a(k);
    } else {
      if (want_x)
        for (int k = tt; k < p * (TC / 4); k += NT) cp_x(k);
      if (want_a)
        for (int k = tt; k < p * (TC / AV); k += NT) cp_a(k);
    }
  } else {
    if (want_x)
      for (int k = tt; k < p * TC; k += NT) {
        const int i = k / TC, j = k % TC;
        if (j < valid) stx[i * TC + j] = src.xrow(i, l0)[j];
      }
    if (want_a)
      for (int k = tt; k < p * TC; k += NT) {
        const int i = k / TC, j = k % TC;
        if (j < valid) sta[i * TC + j] = src.arow(i, l0)[j];
      }
  }
}

// One sweep of the synchronous kind, for genes of a few tiles (the resident
// kernels 1 and 3): all 256 threads, thread (q = t / 64, c = t % 64) rows
// q Q .. q Q + Q - 1 of column c, load a tile's X (and A0, into the second
// buffer) straight into S, UG groups of four rows in flight, sum v's
// quarters in a fixed order, update S in place; then every thread adds its
// R x R block of the full Gram (g, the power step's register tile between
// sweeps), both triangles.  (The triangle
// on four warps, the pipelined sweep's, lost to this full tile on eight
// here: with nothing to overlap, four warps issue their fmas at under half
// the rate of eight.)  Ends with the Gram in w.B (visible).
template <int PMAX, bool ADAPT, bool MERGED, class Src, class Red>
__device__ __forceinline__ void wide_sweep_sync(const Src& src,
                                                const Red& red,
                                                WideWork<PMAX>& w,
                                                WideGram<PMAX>& g, int p,
                                                float step, float s,
                                                bool from_x,
                                                unsigned long long& bits) {
  constexpr int Q = WideShape<PMAX>::Q, LD = WideShape<PMAX>::LD;
  constexpr int UG = WideShape<PMAX>::UG, TC = DN_WIDE_TC;
  const int t = threadIdx.x, q = t >> 6, c = t & (TC - 1), i0 = q * Q;
  const int nloc = src.n_local();
  const bool bits_ok = nloc <= 64 * TC;
  float* Sc = w.S + c * LD + i0;   // this thread's rows of its column in S
  float* Ac = w.S1 + c * LD + i0;  // ... and of its A0
  g.zero();
  for (int l0 = 0, k = 0; l0 < nloc; l0 += TC, ++k) {
    const int l = l0 + c;
    const bool on = (MERGED && bits_ok) ? ((bits >> k) & 1ull) != 0
                                        : src.on(l);
    if constexpr (!MERGED) {
      // four rows at a time, straight into S, UG groups' loads in flight
#pragma unroll 1
      for (int g0 = 0; g0 < Q / 4; g0 += UG) {
#pragma unroll
        for (int gg = 0; gg < UG; ++gg) {
          const int k4 = 4 * (g0 + gg);
          float x[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = i0 + k4 + j;
            float v = 0.f;
            if (on && i < p) {
              if (from_x) {
                v = src.x(l, i);
              } else {
                v = src.a0(l, i);
                src.set_x(l, i, v);
              }
            }
            x[j] = v;
          }
          wide_st<4>(Sc + k4, x);
        }
      }
      if (on && k < 64) bits |= 1ull << k;
      if (!__syncthreads_or(on)) {  // S is read before the next tile
        __syncthreads();
        continue;
      }
    } else {
      // this thread's rows of X into S and of A0 into the A0 tile (zeros
      // off the mask), every load in flight at once, and its partial of v
      float vp = 0.f;
#pragma unroll 1
      for (int g0 = 0; g0 < Q / 4; g0 += UG) {
#pragma unroll
        for (int gg = 0; gg < UG; ++gg) {
          const int k4 = 4 * (g0 + gg);
          float x[4], a[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = i0 + k4 + j;
            const bool row = on && i < p;
            x[j] = row ? src.x(l, i) : 0.f;
            a[j] = row ? src.a0(l, i) : 0.f;
            vp = fmaf(x[j], w.u[i], vp);
          }
          wide_st<4>(Sc + k4, x);
          wide_st<4>(Ac + k4, a);
        }
      }
      w.vpart[q * TC + c] = vp;
      // a tile with no active column leaves X and the Gram as they are
      if (!__syncthreads_or(on)) continue;
      if (on) {  // a column outside the mask stays exactly zero
        const float v = ((w.vpart[c] + w.vpart[TC + c]) + w.vpart[2 * TC + c]) +
                        w.vpart[3 * TC + c];
        // ADAPT: est = K_i E_w taken as u_i (s E_w), as nmf_core does
        const float se = ADAPT ? __fmul_rn(s, v / (s + DN_EPS)) : v;
#pragma unroll
        for (int k4 = 0; k4 < Q; k4 += 4) {
          float x[4], a[4];
          wide_ld<4>(Sc + k4, x);
          wide_ld<4>(Ac + k4, a);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = i0 + k4 + j;
            if (i < p) {
              x[j] = fmaxf(x[j] - step * (w.u[i] * se - a[j]), a[j]);
              src.set_x(l, i, x[j]);
            }
          }
          wide_st<4>(Sc + k4, x);
        }
      }
      __syncthreads();
    }
    g.template syrk<false>(w.S, TC, 1.f);
    __syncthreads();  // S and vpart are read before the next tile
  }
  red.reduce(g, w);
}

// One sweep over the gene's tiles.  The cold one (MERGED false): X = A0 (or
// the X held, from_x) and its Gram; a merged one: v = u^T X, the multiplier
// update X <- max(X - step (u v - A0), A0) and the Gram of the new X.  The
// tile threads: wait for tile k's copy, v (each thread the partials of two
// quarters of its column's rows, in row order, summed over the four
// quarters in a fixed order), the update (X written back to device
// memory), the tile into buffer k & 1 (once the gram threads are done with
// it), the next tile's copy issued, the buffer handed over.  The gram
// threads: the triangle of each buffer that holds an active column.  Ends
// with the Gram in w.B (visible).
template <int PMAX, bool ADAPT, bool MERGED, class Src, class Red>
__device__ __forceinline__ void wide_sweep(const Src& src, const Red& red,
                                           WideWork<PMAX>& w, int p,
                                           float step, float s, bool from_x,
                                           unsigned long long& bits) {
  constexpr int Q = WideShape<PMAX>::Q, LD = WideShape<PMAX>::LD;
  constexpr int TC = DN_WIDE_TC, NT = DN_WIDE_TILE_THREADS;
  constexpr bool TWO = dn_wide_core_blocks<PMAX>() == 2;
  const int t = threadIdx.x, tt = t - DN_WIDE_GRAM_THREADS;
  const int nloc = src.n_local(), ntile = (nloc + TC - 1) / TC;
  const bool bits_ok = nloc <= 64 * TC;
  WideTri<PMAX> tri(t);
  WideDiag<PMAX> dg(tt);
  if (t < DN_WIDE_GRAM_THREADS) {
    tri.zero();
    for (int k = 0; k < ntile; ++k) {
      const int b = k & 1;
      dn_bar_sync(DN_BAR_FULL + b, DN_WIDE_THREADS);
      if (w.active(k)) tri.syrk(w.Sb(b), TC);
      dn_bar_arrive(DN_BAR_EMPTY + b, DN_WIDE_THREADS);
    }
  } else {
    using A = typename Src::AType;
    constexpr int NST = WideShape<PMAX>::NST;
    const int h = tt >> 6, c = tt & (TC - 1), i0 = 2 * h * Q;
    const bool want_x = MERGED || from_x, want_a = MERGED || !from_x;
    // this thread's column of tile k is active
    const auto col_on = [&](int k) {
      if (k >= ntile) return false;
      return (MERGED && bits_ok) ? ((bits >> k) & 1ull) != 0
                                 : src.on(k * TC + c);
    };
    // tile k's vote: the h = 0 warps cover its 64 columns
    const auto vote = [&](int k, bool on) {
      if (h == 0) {
        const unsigned any = __ballot_sync(DN_FULL, on);
        if ((tt & 31) == 0) w.flag[2 * (k & 3) + (tt >> 5)] = any != 0u;
      }
    };
    // the first NST tiles' copies (a group a tile, empty for an inactive
    // one, so that tile k's group is the (k + 1)-th)
    for (int k = 0; k < NST; ++k) vote(k, col_on(k));
    dn_bar_sync(DN_BAR_TILE, NT);
    for (int k = 0; k < NST; ++k) {
      if (k < ntile && w.active(k))
        wide_stage<PMAX>(src, w, p, k * TC, k, want_x, want_a, tt);
      dn_cp_async_commit();
    }
    for (int k = 0; k < ntile; ++k) {
      const int b = k & 1, slot = k % NST, l0 = k * TC, l = l0 + c;
      const bool on = col_on(k), act = w.active(k);
      const float* stx = w.stx + slot * PMAX * TC;
      const A* sta = (const A*)w.sta + slot * PMAX * TC;
      if (k >= 2) dn_bar_sync(DN_BAR_EMPTY + b, DN_WIDE_THREADS);
      if (act) {
        if constexpr (NST == 2)
          asm volatile("cp.async.wait_group 1;" ::: "memory");
        else
          dn_cp_async_wait_all();
        dn_bar_sync(DN_BAR_TILE, NT);  // tile k is in its slot
        float se = 0.f;
        if constexpr (MERGED) {
          // (not unrolled at two blocks an SM, 128 registers a thread)
#pragma unroll (TWO ? 1 : 2)
          for (int h2 = 0; h2 < 2; ++h2) {
            float vp = 0.f;
            if (on) {  // (rows past p add x = 0 times u = 0, as ever)
#pragma unroll (TWO ? 1 : 2)
              for (int j = 0; j < Q; ++j) {
                const int i = i0 + h2 * Q + j;
                vp = fmaf(i < p ? stx[i * TC + c] : 0.f, w.u[i], vp);
              }
            }
            w.vpart[(2 * h + h2) * TC + c] = vp;
          }
          dn_bar_sync(DN_BAR_TILE, NT);
          const float v =
              ((w.vpart[c] + w.vpart[TC + c]) + w.vpart[2 * TC + c]) +
              w.vpart[3 * TC + c];
          // ADAPT: est = K_i E_w taken as u_i (s E_w), as nmf_core does
          se = ADAPT ? __fmul_rn(s, v / (s + DN_EPS)) : v;
        }
        float* Sc = w.Sb(b) + c * LD + i0;
#pragma unroll 1
        for (int k4 = 0; k4 < 2 * Q; k4 += 4) {
          float x[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = i0 + k4 + j;
            float xv = 0.f;
            if (on && i < p) {
              if (MERGED || !from_x) {
                const float a = src.a0v(sta[i * TC + c], i);
                if constexpr (MERGED)
                  xv = fmaxf(stx[i * TC + c] - step * (w.u[i] * se - a), a);
                else
                  xv = a;
                src.set_x(l, i, xv);
              } else {
                xv = stx[i * TC + c];
              }
            }
            x[j] = xv;
          }
          wide_st<4>(Sc + k4, x);
        }
        if (!MERGED && on && k < 64) bits |= 1ull << k;
      }
      // tile k + NST's vote (its ring slot was last read for tile k + NST
      // - 4, before the gram threads handed buffer b back)
      vote(k + NST, col_on(k + NST));
      dn_bar_sync(DN_BAR_TILE, NT);  // buffer b written, the slot read
      if (k + NST < ntile && w.active(k + NST))
        wide_stage<PMAX>(src, w, p, l0 + NST * TC, slot, want_x, want_a, tt);
      dn_cp_async_commit();
      dn_bar_arrive(DN_BAR_FULL + b, DN_WIDE_THREADS);
      if (act) dg.syrk(w.Sb(b), TC);
    }
    dn_cp_async_wait_all();
    // the gram threads' last hand-backs
    for (int k = ntile > 2 ? ntile - 2 : 0; k < ntile; ++k)
      dn_bar_sync(DN_BAR_EMPTY + (k & 1), DN_WIDE_THREADS);
  }
  __syncthreads();
  red.reduce(tri, dg, w);
}

// The whole Lagrangian NMF-OA loop of one gene by a block of
// DN_WIDE_THREADS threads (kernel 4: by each block of the gene's cluster,
// `red` summing their Gram partials).  As common.cuh::nmf_core, with its
// ADAPT and from_x branches and results; u starts in w.u (visible, zero
// beyond p) and comes back refit there, identical in every block of the
// gene.  `src` gives the local column slots l < n_local(): on(l), the rows
// of a tile as stored for the copy stage (xrow, arow, valid_cols, vec; the
// A0 value of a stored element, a0v), x(l, i), set_x(l, i, v), store_e(l,
// e).  Returns this thread's share of sum_w E[w].
template <int PMAX, bool ADAPT, class Src, class Red>
__device__ __forceinline__ float wide_core(const Src& src, const Red& red,
                                           WideWork<PMAX>& w, int p, float& s,
                                           int nmf_iter, int power_cold,
                                           int power_warm, int warm_plain,
                                           float tol = 0.f,
                                           int* n_run = nullptr,
                                           bool from_x = false) {
  constexpr int Q = WideShape<PMAX>::Q;
  constexpr int TC = DN_WIDE_TC;
  const int t = threadIdx.x, q = t >> 6, c = t & (TC - 1);
  const int i0 = q * Q;  // this thread's first row in the finish pass
  const int nloc = src.n_local();
  const float step =
      nmf_iter > 0 ? (float)(1.0 / sqrt((double)nmf_iter)) : 0.f;
  WideGram<PMAX> g;  // the power step's register tile
  s = 0.f;

  // cold sweep: X = A0 (or the X held, from_x), Gram of X; a tile thread's
  // slot k (its column of tile k) goes into its bit mask
  unsigned long long bits = 0ull;
  const auto sweep = [&](auto merged) {
    constexpr bool M = decltype(merged)::value;
    if constexpr (Src::PIPE)
      wide_sweep<PMAX, ADAPT, M>(src, red, w, p, step, s, from_x, bits);
    else
      wide_sweep_sync<PMAX, ADAPT, M>(src, red, w, g, p, step, s, from_x,
                                      bits);
  };
  sweep(std::false_type{});
  wide_refit<PMAX>(w, g, power_cold, 0, ADAPT || nmf_iter == 0, s);

  // merged sweeps: v = u^T X, multiplier update, Gram of the new X
  int ran = nmf_iter;
  for (int it = 0; it < nmf_iter; ++it) {
    sweep(std::true_type{});
    if constexpr (ADAPT) {
      const float s_old = s;
      if (t < PMAX) w.uo[t] = w.u[t];
      // (wide_refit's first barrier orders this copy before u changes)
      wide_refit<PMAX>(w, g, power_warm, warm_plain, true, s);
      float delta = 0.f, ref = 0.f;
#pragma unroll 8
      for (int j = 0; j < PMAX; ++j) {
        const float k_new = __fmul_rn(w.u[j], s);
        delta = fmaxf(delta, fabsf(k_new - __fmul_rn(w.uo[j], s_old)));
        ref = fmaxf(ref, fabsf(k_new));
      }
      ref = fmaxf(ref, DN_EPS);
      if (delta <= __fmul_rn(tol, ref)) {  // frozen: this update kept
        ran = it + 1;
        break;
      }
    } else {
      wide_refit<PMAX>(w, g, power_warm, warm_plain, it == nmf_iter - 1, s);
    }
  }
  if (n_run != nullptr) *n_run = ran;

  // finish: E = X^T u / (s + eps), and this thread's share of its sum
  float se = 0.f;
  for (int l0 = 0; l0 < nloc; l0 += TC) {
    const int l = l0 + c;
    const bool on = src.on(l);
    float vp = 0.f;
    if (on) {
#pragma unroll
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
      se += e;
    }
    __syncthreads();
  }
  return se;
}

// The block's sum of its threads' values, in a fixed order (warps, then the
// warps' sums in order), the same in every thread.  Uses w.red; starts and
// ends with a barrier of its own use of it.
template <int PMAX>
__device__ __forceinline__ float wide_block_sum(const WideWork<PMAX>& w,
                                                float v) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) w.red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = 0.f;
#pragma unroll
  for (int k = 0; k < DN_WIDE_THREADS / 32; ++k) r += w.red[k];
  __syncthreads();
  return r;
}

// The resident kernels' gene (kernels 1 and 3): slot l is column l of the
// gene's (p, W) rows; X in the global scratch.
struct WideResidentSrc {
  using AType = float;
  static constexpr bool PIPE = false;  // a few tiles a gene
  const float* __restrict__ F;
  const uint8_t* mask;
  float* X;
  float* E;
  int W;
  __device__ __forceinline__ int n_local() const { return W; }
  __device__ __forceinline__ bool on(int l) const {
    return l < W && mask[l] != 0;
  }
  // the copy stage's view: rows of a tile as stored, 16-byte aligned when
  // W is a multiple of 8
  __device__ __forceinline__ bool vec() const { return W % 8 == 0; }
  __device__ __forceinline__ int valid_cols(int l0) const {
    return W - l0 < DN_WIDE_TC ? W - l0 : DN_WIDE_TC;
  }
  __device__ __forceinline__ const float* xrow(int i, int l0) const {
    return X + i * W + l0;
  }
  __device__ __forceinline__ const float* arow(int i, int l0) const {
    return F + i * W + l0;
  }
  __device__ __forceinline__ float a0v(float a, int) const { return a; }
  __device__ __forceinline__ float a0(int l, int i) const { return F[i * W + l]; }
  __device__ __forceinline__ float x(int l, int i) const { return X[i * W + l]; }
  __device__ __forceinline__ void set_x(int l, int i, float v) const {
    X[i * W + l] = v;
  }
  __device__ __forceinline__ void store_e(int l, float e) const {
    if (l < W) E[l] = e;
  }
};

// p -> the wide instance CALL(PMAX) that holds it (33 <= p <= 128)
#define DN_DISPATCH_WIDE_P(p, CALL) \
  do {                              \
    if ((p) <= 48) {                \
      CALL(48);                     \
    } else if ((p) <= 64) {         \
      CALL(64);                     \
    } else if ((p) <= 96) {         \
      CALL(96);                     \
    } else {                        \
      CALL(128);                    \
    }                               \
  } while (0)

// Most p the wide instances take; above it the panel instance (panel.cuh)
// takes every p.
#define DN_WIDE_MAX_P 128
