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
// accumulators in shared memory would reload it for every product):
//   * a block is 256 threads and sweeps a gene's columns in tiles of
//     DN_WIDE_TC = 64.  In a tile, thread (q = t / 64, c = t % 64) owns rows
//     q Q .. q Q + Q - 1 (Q = PMAX / 4) of column c: it loads their X (and
//     A0) four rows at a time, UG groups in flight, straight into the tile S
//     (TC x PMAX, column-major: a column's rows contiguous; A0 into A), its
//     partial of v_c = sum_i X[i,c] u_i is summed with the three other
//     quarters' in a fixed order through shared memory, and it updates its
//     rows in S in place (so no row is held in registers across a barrier);
//   * thread (ty = t / 16, tx = t % 16) owns the R x R block (R = PMAX / 16)
//     of rows ty R.. and columns tx R.. of the Gram, in registers, and adds
//     S's tile to it with float4 loads (a classic register-tiled SYRK); the
//     full matrix is accumulated, and its two triangles are equal bit for bit
//     (the same products in the same order), so B is exactly symmetric;
//   * a tile with no active column adds nothing and is skipped
//     (__syncthreads_or), which is exact;
//   * after a sweep every thread writes its block of the Gram into B in
//     shared memory (kernel 4: its cluster's blocks sum their partials in
//     rank order through distributed shared memory), and the power step is
//     the block's: B's largest entry by a block reduction, B^2 of the
//     squared scheme as a register tile again (Bn Bn = sum_k Bn[k] Bn[k]^T),
//     each matvec a register tile times a vector in shared memory, reduced
//     over the 16 threads of a half-warp with a fixed xor butterfly, and
//     every norm and dot product summed by each thread itself in one fixed
//     order, so u is bit-equal across the block, the cluster and two runs.
//
// What bounds it on this card: float32 operations, p(p+1) a column a sweep
// for the Gram (the tile computes p^2: both triangles) against 4p bytes of X
// read and written; the SYRK's R x R register tile makes it issue-bound
// rather than shared-memory-bound.  Rows p..PMAX-1 are carried as zeros
// (PMAX in {48, 64, 96, 128}), which is exact.
//
// Shared memory (floats, rows of LD = PMAX + 4, 16-byte aligned, so that a
// quarter-warp's float4 stores into S are conflict-free): S (TC rows), B
// (PMAX rows), the v partials (4 x TC), five p-vectors, 32 floats of
// scratch, then A (TC rows: a tile's A0, loaded beside X before the v
// barrier so that a thread's loads are in flight together): 54,656 bytes at
// PMAX = 64 and 138,880 at PMAX = 128, dynamic shared memory sized at launch
// (cudaFuncSetAttribute above 48 KB); kernel 2 takes it without A.
//
// Kept from common.cuh: sums in a fixed order and no float atomics; plain
// FP32 (no TF32 or bf16 Gram); a thread keeps a 64-bit mask of its active
// column slots (slot k: its column of tile k) from the cold sweep on;
// no -use_fast_math.
#pragma once

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
  // groups of four rows whose loads a sweep issues together: all of them
  // where the registers allow (PMAX 48 and 96), two at PMAX 64 (so that two
  // blocks an SM fit 128 registers a thread) and 128 (255 spilled)
  static constexpr int UG = (PMAX == 48 || PMAX == 96) ? Q / 4 : 2;
};

// Blocks an SM named in the launch bounds of kernels 1, 2 and 4: two at
// PMAX <= 64 (they then fit 128 registers a thread), else one (up to 255).
// Kernel 3 names one at every PMAX: its own state spilled at 128.
template <int PMAX>
__host__ __device__ constexpr int dn_wide_min_blocks() {
  return PMAX <= 64 ? 2 : 1;
}

// Floats of the core's shared memory (WideWork) without its tile A, which
// only the merged sweeps use (kernel 2 launches with this much) ...
template <int PMAX>
__host__ __device__ constexpr int wide_core_floats() {
  return DN_WIDE_TC * WideShape<PMAX>::LD + PMAX * WideShape<PMAX>::LD +
         4 * DN_WIDE_TC + 5 * PMAX + 32;
}

// ... and with it (kernels 1, 3 and 4).
template <int PMAX>
__host__ __device__ constexpr int wide_work_floats() {
  return wide_core_floats<PMAX>() + DN_WIDE_TC * WideShape<PMAX>::LD;
}

// The core's shared memory, carved from a 16-byte aligned base.
template <int PMAX>
struct WideWork {
  float* S;      // TC x LD: a tile's columns, rows contiguous
  float* A;      // TC x LD: the tile's A0, loaded beside X (merged sweeps)
  float* B;      // PMAX x LD: the gene's Gram
  float* vpart;  // 4 x TC: the quarters' partials of v
  float* u;      // PMAX: the left vector (zero beyond p)
  float* va;     // PMAX: matvec results
  float* vb;
  float* vc;
  float* uo;     // PMAX: the previous u (ADAPT)
  float* red;    // 32: block reductions
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
    A = red + 32;  // last: a launch without it ends before it
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

// The reduction of a block that owns a whole gene: its Gram block goes to
// w.B.  (Kernel 4's cluster has its own: stream_wide.cuh.)
struct WideBlockRed {
  template <int PMAX>
  __device__ __forceinline__ void reduce(WideGram<PMAX>& g,
                                         WideWork<PMAX>& w) const {
    g.store(w.B);
    __syncthreads();
  }
};

// The whole Lagrangian NMF-OA loop of one gene by a block of
// DN_WIDE_THREADS threads (kernel 4: by each block of the gene's cluster,
// `red` summing their Gram partials).  As common.cuh::nmf_core, with its
// ADAPT and from_x branches and results; u starts in w.u (visible, zero
// beyond p) and comes back refit there, identical in every block of the
// gene.  `src` gives runtime rows: on(l), a0(l, i), x(l, i), set_x(l, i, v),
// store_e(l, e) for local column slots l < n_local().  Returns this thread's
// share of sum_w E[w].
template <int PMAX, bool ADAPT, class Src, class Red>
__device__ __forceinline__ float wide_core(const Src& src, const Red& red,
                                           WideWork<PMAX>& w, int p, float& s,
                                           int nmf_iter, int power_cold,
                                           int power_warm, int warm_plain,
                                           float tol = 0.f,
                                           int* n_run = nullptr,
                                           bool from_x = false) {
  constexpr int Q = WideShape<PMAX>::Q, LD = WideShape<PMAX>::LD;
  constexpr int UG = WideShape<PMAX>::UG;
  constexpr int TC = DN_WIDE_TC;
  const int t = threadIdx.x, q = t >> 6, c = t & (TC - 1);
  const int i0 = q * Q;  // this thread's first row in a tile
  const int nloc = src.n_local();
  const float step =
      nmf_iter > 0 ? (float)(1.0 / sqrt((double)nmf_iter)) : 0.f;
  WideGram<PMAX> g;
  float* Sc = w.S + c * LD + i0;  // this thread's rows of its column in S
  float* Ac = w.A + c * LD + i0;  // ... and in A
  s = 0.f;

  // cold sweep: X = A0 (or the X held, from_x), Gram of X; slot k (this
  // thread's column of tile k) goes into the bit mask
  const bool bits_ok = nloc <= 64 * TC;
  unsigned long long bits = 0ull;
  g.zero();
  for (int l0 = 0, k = 0; l0 < nloc; l0 += TC, ++k) {
    const int l = l0 + c;
    const bool on = src.on(l);
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
    if (__syncthreads_or(on)) g.template syrk<false>(w.S, TC, 1.f);
    __syncthreads();  // S is read before the next tile writes it
  }
#define DN_WIDE_ON(k, l) (bits_ok ? ((bits >> (k)) & 1ull) != 0 : src.on(l))
  red.reduce(g, w);
  wide_refit<PMAX>(w, g, power_cold, 0, ADAPT || nmf_iter == 0, s);

  // merged sweeps: v = u^T X, multiplier update, Gram of the new X
  int ran = nmf_iter;
  for (int it = 0; it < nmf_iter; ++it) {
    g.zero();
    for (int l0 = 0, k = 0; l0 < nloc; l0 += TC, ++k) {
      const int l = l0 + c;
      const bool on = DN_WIDE_ON(k, l);
      // this thread's rows of X into S and of A0 into A (zeros off the
      // mask), four at a time, every load in flight at once, and its
      // partial of v; S and A hold them across the barrier
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
      g.template syrk<false>(w.S, TC, 1.f);
      __syncthreads();  // S and vpart are read before the next tile
    }
    red.reduce(g, w);
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
  for (int l0 = 0, k = 0; l0 < nloc; l0 += TC, ++k) {
    const int l = l0 + c;
    const bool on = DN_WIDE_ON(k, l);
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
#undef DN_WIDE_ON
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
  const float* __restrict__ F;
  const uint8_t* mask;
  float* X;
  float* E;
  int W;
  __device__ __forceinline__ int n_local() const { return W; }
  __device__ __forceinline__ bool on(int l) const {
    return l < W && mask[l] != 0;
  }
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

// Most p the wide instances take.
#define DN_WIDE_MAX_P 128
