// Shared device code of the DegNorm CUDA kernels (sm_90a, plain float32).
//
// Replaces the shared helpers of the TPU kernels in
// degnorm_tpu/ops/pallas_nmf.py (_gram, _power, _power_warm, _rank1_uv,
// _finish_KE, _nmf_loop), which ops/pallas_trim.py imports the same way
// this header is included by nmf.cu, ratio.cuh, trim.cu and stream.cuh.
//
// nmf_core below is the whole Lagrangian NMF-OA loop of one gene, shared by
// kernel 1 (nmf.cu: a block or a warp a gene), kernel 3 (trim.cu) and kernel
// 4 (stream.cuh).  A thread owns whole columns of the gene's (p, W) matrix,
// so one sweep per Lagrangian iteration does everything that touches the
// wide axis:
// v_w = sum_i X[i,w] u_i (the previous iterate's right vector, never
// stored), the X-form multiplier update, and the Gram of the new X.  Where
// the columns come from and where X lives is the caller's `Src`; how the
// Gram partials of the warps (and, in stream.cuh, of a cluster's blocks) are
// brought together is the caller's `Red`; which threads run the gene is the
// caller's `Geo` (the block, or one warp with its own workspace).
//
// What bounds a sweep on this card is not its float32 operations (about
// p(p+1) + 8p a column) nor its bytes, but latency: a thread needs about 120
// registers at p = 8, so an SM holds 16 warps, and what a sweep costs besides
// its columns is paid every sweep, nmf_iter times a loop, by every warp of
// the gene: the reduction of the Gram, the barrier, the p x p power step.
// What the design does about it:
//   * few warps a gene and many columns a thread (the wrappers' rules in
//     ops/cuda_nmf.py and ops/cuda_stream.py), and no register spill: every
//     p <= 16 instance fits its launch bound;
//   * p == PMAX is a template argument (FULL): no load, store or update of a
//     sweep is predicated on a runtime p (a third of a sweep's time);
//   * a thread keeps a bit mask of its active column slots from the first
//     pass on, so a sweep waits for no mask byte;
//   * p <= 8: a thread keeps the p(p+1)/2 Gram partials in registers and a
//     warp reduces them with a transposing butterfly (warp_reduce_store:
//     each step halves the values a lane carries, N + 15 shuffles for N
//     values against 5 N for N plain shuffle reductions), in a fixed order;
//   * p >= 16: no thread could hold 136 or 528 partials.  A warp stages its
//     32 columns in a shared-memory tile and lane (i, h) owns the pairs
//     (i, i + d mod p), d = 0..p/2, over the tile's columns (WarpGram: 9 or
//     17 accumulators a lane, bank-conflict-free at a row stride of 33); u
//     is read from the warp's shared copy and A0 comes 8 rows at a time;
//   * after ONE barrier every warp sums the partials itself in a fixed order
//     and runs the power step on identical numbers (power_refit, one IEEE
//     reciprocal instead of p divides), so u is bit-equal across warps,
//     blocks and runs without a hand-off to warp 0; lane i holds u_i.
// Built, measured and taken out (PERF.md): loading the next column ahead of
// its use (its registers spilled at the 128 of a 512-thread block) and X or
// the coverage of a resident gene in shared memory (fewer blocks an SM).
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

// Row i of the gene exists.  FULL (a template argument where this is used)
// says p == PMAX: every row does, and no load, store or update of the sweeps
// is predicated on a runtime p, which costs a third of a sweep's time.
#define DN_ROW(i) (FULL || (i) < p)
#define DN_EPS 1e-30f
#define DN_FULL 0xffffffffu
#define DN_TILE_STRIDE 33  // floats a row of a warp's Gram tile

// Most warps a block of a loop kernel may have: the p <= 8 instances need
// few registers and little shared memory a warp, the others a Gram tile each.
template <int PMAX>
__host__ __device__ constexpr int dn_max_warps() {
  return PMAX <= 8 ? 16 : 8;
}

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

// (float)raw / s for an int16 numerator, from r = 1 / s (IEEE, hoisted):
// kernel 4's int16 + scale input (stream.cuh).
__device__ __forceinline__ float scaled_i16(int16_t raw, float s, float r) {
  const float a = (float)raw;
  float q = __fmul_rn(a, r);
  float e = __fmaf_rn(-q, s, a);
  q = __fmaf_rn(e, r, q);
  e = __fmaf_rn(-q, s, a);
  return __fmaf_rn(e, r, q);
}

// A coverage value of kernel 2 as stored: int16 (exact) or float32.
__device__ __forceinline__ float ratio_val(int16_t v) { return (float)v; }
__device__ __forceinline__ float ratio_val(float v) { return v; }

__host__ __device__ constexpr int dn_pow2_ceil(int n) {
  int m = 1;
  while (m < n) m <<= 1;
  return m;
}

__host__ __device__ constexpr int dn_log2(int m) {
  int l = 0;
  while ((1 << l) < m) ++l;
  return l;
}

// Transposing butterfly over M <= 32 values a lane (M a power of two): step
// `off` = 16, 8, ... pairs lane with lane ^ off, which keep one half of the
// values each and add the partner's copy of that half.  After log2(M) steps a
// lane carries ONE value, element lane >> (5 - log2 M), summed over the lanes
// that share its top log2(M) bits; plain xor steps finish the sum.  The order
// of the additions is fixed by the lane numbers alone.
template <int M, int OFF = 16>
__device__ __forceinline__ float warp_butterfly(const float (&a)[M],
                                                int lane) {
  if constexpr (M == 1) {
    float v = a[0];
#pragma unroll
    for (int o = OFF; o >= 1; o /= 2) v += __shfl_xor_sync(DN_FULL, v, o);
    return v;
  } else {
    // a step is its own instantiation, so every index is a constant and the
    // values stay in registers
    constexpr int H = M / 2;
    const bool up = (lane & OFF) != 0;
    float b[H];
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const float send = up ? a[k] : a[k + H];
      const float keep = up ? a[k + H] : a[k];
      b[k] = keep + __shfl_xor_sync(DN_FULL, send, OFF);
    }
    return warp_butterfly<H, OFF / 2>(b, lane);
  }
}

// Warp-wide sums of N per-lane values into out[0..N).  Whole warp calls.
template <int N>
__device__ __forceinline__ void warp_reduce_store(const float (&acc)[N],
                                                  float* out, int lane) {
  constexpr int FULL = N / 32, R = N % 32;
#pragma unroll
  for (int b = 0; b < FULL; ++b) {
    float t[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) t[k] = acc[b * 32 + k];
    const float v = warp_butterfly<32>(t, lane);
    out[b * 32 + lane] = v;
  }
  if constexpr (R > 0) {
    constexpr int M = dn_pow2_ceil(R);
    constexpr int SH = 5 - dn_log2(M);
    float t[M];
#pragma unroll
    for (int k = 0; k < M; ++k) t[k] = k < R ? acc[FULL * 32 + k] : 0.f;
    const float v = warp_butterfly<M>(t, lane);
    const int e = lane >> SH;
    if ((lane & ((1 << SH) - 1)) == 0 && e < R) out[FULL * 32 + e] = v;
  }
}

// index of (a, b), a <= b, in the row-major packed upper triangle
template <int PMAX>
__device__ __forceinline__ int packed_index(int a, int b) {
  return a * PMAX - (a * (a - 1)) / 2 + (b - a);
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

// A warp's Gram partial over the columns it sweeps.  add() is called by the
// whole warp once per 32 columns (lane = column); flush() leaves the packed
// upper triangle of the warp's partial in out[0..NG).
template <int PMAX, bool TILE = (PMAX >= 16)>
struct WarpGram;

// p <= 8: the partials stay in the thread's registers.
template <int PMAX>
struct WarpGram<PMAX, false> {
  static constexpr int NG = PMAX * (PMAX + 1) / 2;
  float acc[NG];
  __device__ __forceinline__ void init(float*) {}
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int k = 0; k < NG; ++k) acc[k] = 0.f;
  }
  __device__ __forceinline__ void add(const float (&x)[PMAX], bool on, int) {
    if (on) gram_accumulate<PMAX>(x, acc);
  }
  __device__ __forceinline__ void flush(float* out, int lane) {
    warp_reduce_store<NG>(acc, out, lane);
  }
};

// p >= 16: a small SYRK over a shared-memory tile of the warp's 32 columns.
// Lane (i = lane % PMAX, h = lane / PMAX) owns the pairs (i, (i + d) % PMAX),
// d = 0..PMAX/2, over the columns h * PMAX .. h * PMAX + PMAX - 1 of the
// tile: PMAX/2 + 1 accumulators a lane, and only the two column halves of
// PMAX = 16 are left to sum across lanes.
template <int PMAX>
struct WarpGram<PMAX, true> {
  static constexpr int NG = PMAX * (PMAX + 1) / 2;
  static constexpr int D = PMAX / 2 + 1;
  float acc[D];
  float* tile;  // this warp's PMAX x DN_TILE_STRIDE floats
  __device__ __forceinline__ void init(float* t) { tile = t; }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.f;
  }
  __device__ __forceinline__ void add(const float (&x)[PMAX], bool on,
                                      int lane) {
    if (!__any_sync(DN_FULL, on)) return;  // the same answer in every lane
#pragma unroll
    for (int i = 0; i < PMAX; ++i)
      tile[i * DN_TILE_STRIDE + lane] = on ? x[i] : 0.f;
    __syncwarp();
    const int i = lane & (PMAX - 1), c0 = (lane / PMAX) * PMAX;
#pragma unroll 4
    for (int k = 0; k < PMAX; ++k) {
      const float xi = tile[i * DN_TILE_STRIDE + c0 + k];
#pragma unroll
      for (int d = 0; d < D; ++d)
        acc[d] = fmaf(
            xi, tile[((i + d) & (PMAX - 1)) * DN_TILE_STRIDE + c0 + k],
            acc[d]);
    }
    __syncwarp();
  }
  __device__ __forceinline__ void flush(float* out, int lane) {
    const int i = lane & (PMAX - 1);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float v = acc[d];
#pragma unroll
      for (int o = 16; o >= PMAX; o >>= 1) v += __shfl_xor_sync(DN_FULL, v, o);
      // a pair at distance PMAX/2 is reached from both of its rows
      if (lane < PMAX && (d < PMAX / 2 || i < PMAX / 2)) {
        const int j = (i + d) & (PMAX - 1);
        out[packed_index<PMAX>(i < j ? i : j, i < j ? j : i)] = v;
      }
    }
  }
};

// Lane `lane` loads row `lane` of the symmetric Gram from its packed upper
// triangle; lanes >= PMAX get zeros.
template <int PMAX>
__device__ __forceinline__ void load_gram_row(const float* packed, int lane,
                                              float (&row)[PMAX]) {
#pragma unroll
  for (int j = 0; j < PMAX; ++j) {
    int a = lane < j ? lane : j, b = lane < j ? j : lane;
    row[j] = (lane < PMAX) ? packed[packed_index<PMAX>(a, b)] : 0.f;
  }
}

// Row of B / (max|B| + eps), the max taken over the whole matrix.  The plain
// version (core/linalg.py::_normalized) divides each entry; here it is one
// reciprocal and a product, which may differ from the quotient in the last
// bit: a common scale of B that the power steps normalise away.
template <int PMAX>
__device__ __forceinline__ void normalize_rows(const float (&row)[PMAX],
                                               float (&out)[PMAX]) {
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < PMAX; ++j) m = fmaxf(m, fabsf(row[j]));
  m = warp_max(m);
  // one IEEE reciprocal, not PMAX divides: every warp runs this each sweep
  const float inv = 1.0f / (m + DN_EPS);
#pragma unroll
  for (int j = 0; j < PMAX; ++j) out[j] = row[j] * inv;
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
// two B^2 applications.  A whole warp must call this.
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

// The same as a call: at p >= 16 its three p-vectors and p x p unrolled body
// would otherwise be allotted registers beside the sweeps' own (it runs once
// a loop, at the cold start).
template <int PMAX>
__device__ __noinline__ float power_squared_call(const float (&row)[PMAX],
                                                 float u, int n_iters) {
  return power_squared<PMAX>(row, u, n_iters);
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

// A whole warp refits u (lane i holds u_i, zero beyond p) from its Gram row;
// with `finish`, also s = sqrt(max(u^T B u, 0)) into `s` (every lane).
template <int PMAX>
__device__ __forceinline__ float power_refit(const float (&row)[PMAX], float u,
                                             int n_squared, int n_plain,
                                             bool finish, float& s) {
  if (n_plain > 0)
    u = power_plain<PMAX>(row, u, n_plain);
  else if constexpr (PMAX >= 16)
    u = power_squared_call<PMAX>(row, u, n_squared);
  else
    u = power_squared<PMAX>(row, u, n_squared);
  if (finish) {
    const float bu = warp_matvec<PMAX>(row, u);
    s = sqrtf(fmaxf(warp_sum(u * bu), 0.f));
  }
  return u;
}

// Floats of dynamic shared memory a warp of a p >= 16 instance works in: its
// Gram tile and, after it, its copy of u (UVec).
template <int PMAX>
__host__ __device__ constexpr int warp_work_floats() {
  return PMAX >= 16 ? PMAX * DN_TILE_STRIDE + PMAX : 0;
}

// Floats of dynamic shared memory the warps' workspaces of a block take.
template <int PMAX>
__host__ __device__ constexpr size_t gram_tile_floats(int warps) {
  return (size_t)warps * warp_work_floats<PMAX>();
}

// The reduction of a resident kernel's block (one block = one gene): the
// warps' packed Gram partials, double-buffered by sweep parity so that ONE
// barrier a sweep is enough (a warp that runs ahead writes the other half).
template <int PMAX, int MAXW = dn_max_warps<PMAX>()>
struct BlockRed {
  static constexpr int NG = PMAX * (PMAX + 1) / 2;
  float part[2][MAXW][NG];

  template <class G>
  __device__ __forceinline__ float refit(G& gram, int parity, float u,
                                         int n_squared, int n_plain,
                                         bool finish, float& s) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    gram.flush(part[parity][warp], lane);
    __syncthreads();
    float row[PMAX];
#pragma unroll
    for (int j = 0; j < PMAX; ++j) {
      const int a = lane < j ? lane : j, b = lane < j ? j : lane;
      const int idx = lane < PMAX ? packed_index<PMAX>(a, b) : 0;
      float t = 0.f;
      for (int w = 0; w < nw; ++w) t += part[parity][w][idx];
      row[j] = lane < PMAX ? t : 0.f;
    }
    return power_refit<PMAX>(row, u, n_squared, n_plain, finish, s);
  }
};

// The columns of a resident kernel's gene: local slot l is column l.
//   (offsets within a gene are ints: p * W is at most 65,536 inside the gate)
//   F: (p, W) coverage rows; mask: (W) bytes; X: (p, W) multiplier rows in
//   the global scratch; E: (W) output.
// mask, X and E carry no __restrict__: the trim kernel rewrites its column
// mask and E between loops, so their loads must not take the read-only path.
template <int PMAX, bool FULL>
struct ResidentSrc {
  const float* __restrict__ F;
  const uint8_t* mask;
  float* X;
  float* E;
  int p, W;
  __device__ __forceinline__ int n_local() const { return W; }
  __device__ __forceinline__ bool on(int l) const {
    return l < W && mask[l] != 0;
  }
  __device__ __forceinline__ float a_at(int l, int i) const {
    return DN_ROW(i) ? F[i * W + l] : 0.f;
  }
  __device__ __forceinline__ void load_a0(int l, float (&a)[PMAX]) const {
#pragma unroll
    for (int i = 0; i < PMAX; ++i) a[i] = a_at(l, i);
  }
  __device__ __forceinline__ void load_x(int l, float (&x)[PMAX]) const {
#pragma unroll
    for (int i = 0; i < PMAX; ++i) x[i] = DN_ROW(i) ? X[i * W + l] : 0.f;
  }
  __device__ __forceinline__ void store_x(int l, const float (&x)[PMAX]) const {
#pragma unroll
    for (int i = 0; i < PMAX; ++i)
      if (DN_ROW(i)) X[i * W + l] = x[i];
  }
  __device__ __forceinline__ void store_e(int l, float e) const {
    if (l < W) E[l] = e;
  }
};

template <int PMAX>
__device__ __forceinline__ void expand_u(float u_lane, float (&u)[PMAX]) {
#pragma unroll
  for (int i = 0; i < PMAX; ++i) u[i] = __shfl_sync(DN_FULL, u_lane, i);
}

// u as the column loops read it: p <= 8 in the thread's registers; p >= 16,
// where registers are short, in the warp's own shared-memory copy.
template <int PMAX, bool SHARED = (PMAX >= 16)>
struct UVec;

template <int PMAX>
struct UVec<PMAX, false> {
  float u[PMAX];
  __device__ __forceinline__ void init(float*) {}
  __device__ __forceinline__ void set(float u_lane, int) {
    expand_u<PMAX>(u_lane, u);
  }
  __device__ __forceinline__ float operator[](int i) const { return u[i]; }
};

template <int PMAX>
struct UVec<PMAX, true> {
  float* us;
  __device__ __forceinline__ void init(float* buf) { us = buf; }
  __device__ __forceinline__ void set(float u_lane, int lane) {
    __syncwarp();
    if (lane < PMAX) us[lane] = u_lane;
    __syncwarp();
  }
  __device__ __forceinline__ float operator[](int i) const { return us[i]; }
};

// The threads that run one gene's loop in nmf_core: the whole block (kernels
// 1, 3 and 4: BlockGeo) or one warp of it (kernel 1's warp-a-gene launch:
// WarpGeo, whose constants let the compiler drop the block arithmetic).
struct BlockGeo {
  __device__ __forceinline__ int threads() const { return blockDim.x; }
  __device__ __forceinline__ int warp() const { return threadIdx.x >> 5; }
};
struct WarpGeo {
  __device__ __forceinline__ int threads() const { return 32; }
  __device__ __forceinline__ int warp() const { return 0; }
};

// The reduction of a warp that owns a whole gene: after the butterfly the
// warp's Gram partial IS the gene's Gram, so there is no block barrier and
// no cross-warp sum, only a __syncwarp on each side of the flush.  `part`
// is the warp's own NG floats of shared memory.
template <int PMAX>
struct WarpRed {
  float* part;

  template <class G>
  __device__ __forceinline__ float refit(G& gram, int, float u, int n_squared,
                                         int n_plain, bool finish, float& s) {
    const int lane = threadIdx.x & 31;
    __syncwarp();  // every lane has read the previous sweep's Gram
    gram.flush(part, lane);
    __syncwarp();
    float row[PMAX];
    load_gram_row<PMAX>(part, lane, row);
    return power_refit<PMAX>(row, u, n_squared, n_plain, finish, s);
  }
};

// The active columns of one gene, compacted by the caller: slot l is column
// idx[l], l < n, so a sweep walks ceil(n / 32) groups with every lane on.
// X of the first xcap slots and the masked coverage (A0) of the first acap
// slots sit in shared memory (rows of xcap / acap floats, written by the cold
// sweep); X of the others in the gene's global scratch at compact positions
// (rows of W floats, so a row's loads are coalesced), and their A0 is read
// from F again each sweep.  E is written at the active columns only: the
// caller zeroes the others.
template <int PMAX, bool FULL>
struct CompactSrc {
  const float* __restrict__ F;
  const uint16_t* idx;
  float* Xg;
  float* Xs;
  float* As;
  float* E;
  int p, W, n, xcap, acap;
  __device__ __forceinline__ int n_local() const { return n; }
  __device__ __forceinline__ bool on(int l) const { return l < n; }
  __device__ __forceinline__ float a_at(int l, int i) const {
    if (!DN_ROW(i)) return 0.f;
    return l < acap ? As[i * acap + l] : F[i * W + idx[l]];
  }
  __device__ __forceinline__ void load_a0(int l, float (&a)[PMAX]) const {
    const int w = idx[l];
    const bool keep = l < acap;
#pragma unroll
    for (int i = 0; i < PMAX; ++i) {
      a[i] = DN_ROW(i) ? F[i * W + w] : 0.f;
      if (keep && DN_ROW(i)) As[i * acap + l] = a[i];
    }
  }
  __device__ __forceinline__ void load_x(int l, float (&x)[PMAX]) const {
    const bool loc = l < xcap;
    const float* base = loc ? Xs : Xg;
    const int stride = loc ? xcap : W;
#pragma unroll
    for (int i = 0; i < PMAX; ++i)
      x[i] = DN_ROW(i) ? base[i * stride + l] : 0.f;
  }
  __device__ __forceinline__ void store_x(int l, const float (&x)[PMAX]) const {
    const bool loc = l < xcap;
    float* base = loc ? Xs : Xg;
    const int stride = loc ? xcap : W;
#pragma unroll
    for (int i = 0; i < PMAX; ++i)
      if (DN_ROW(i)) base[i * stride + l] = x[i];
  }
  __device__ __forceinline__ void store_e(int l, float e) const {
    if (l < n) E[idx[l]] = e;
  }
};

// The whole Lagrangian NMF-OA loop for the gene of `src`, by every thread of
// the block (or of the cluster's blocks: `red` then sums across them), or by
// one warp (Geo = WarpGeo: `tiles` is then that warp's own workspace).
//   u_lane: the start vector, lane i of every warp holds u_i (0 beyond p).
// Returns this thread's share of sum_w E[w]; u_lane and s come back refit
// and identical in every warp; E is written through src.store_e.
//
// Two opt-in branches of the TPU kernels (degnorm_tpu/ops/pallas_nmf.py::
// _nmf_loop and ops/pallas_trim.py::_trim_kernel):
//   * ADAPT (EngineConfig.nmf_tol > 0; a template argument, so that the
//     default instances compile without any of it): the (K, E) carry, each
//     sweep updating X with est = K_i E_w for K = u s and E = v / (s + eps)
//     of the last refit (the default carry's est = u_i v_w without the
//     1e-30 regulariser), s refit every iteration, and the gene's loop ends
//     after the first iteration whose max|K_new - K_old| <= tol * max(max|K|,
//     1e-30) (the update of that iteration kept).  Every warp computes the
//     test on identical numbers, so a block leaves the loop as one; a warp a
//     gene leaves only its own gene's loop.
//   * from_x (trim_fast's rounds after the first): the cold sweep reads the
//     X the gene already holds in src instead of writing X = A0 (a branch
//     of the cold sweep only).
// `n_run`, where given, receives the Lagrangian iterations run.
template <int PMAX, class Geo = BlockGeo, bool ADAPT = false, class Src,
          class Red>
__device__ __forceinline__ float nmf_core(Src& src, Red& red, float* tiles,
                                          float& u_lane, float& s, int nmf_iter,
                                          int power_cold, int power_warm,
                                          int warm_plain, float tol = 0.f,
                                          int* n_run = nullptr,
                                          bool from_x = false) {
  const Geo geo{};
  const int nt = geo.threads(), lane = threadIdx.x & 31, warp = geo.warp();
  const int nloc = src.n_local();
  const float step =
      nmf_iter > 0 ? (float)(1.0 / sqrt((double)nmf_iter)) : 0.f;
  WarpGram<PMAX> gram;
  float* work = tiles + (size_t)warp * warp_work_floats<PMAX>();
  gram.init(work);
  UVec<PMAX> u;
  u.init(work + PMAX * DN_TILE_STRIDE);
  s = 0.f;

  // cold sweep: X = A0 = F * mask (or the X held, from_x), Gram of X; the
  // thread's active slots go into a register bit mask (slot k is local
  // column 32 * warp + lane + k * nt), so no later sweep waits for a mask
  // byte.  A block with more than 64 slots a thread reads the mask in every
  // sweep instead.
  const bool bits_ok = nloc <= 64 * nt;
  unsigned long long bits = 0ull;
  gram.zero();
  for (int l0 = warp * 32, k = 0; l0 < nloc; l0 += nt, ++k) {
    const int l = l0 + lane;
    const bool on = src.on(l);
    float x[PMAX];
    if (on) {
      if (from_x) {
        src.load_x(l, x);
      } else {
        src.load_a0(l, x);  // from the input; the source may keep a copy
        src.store_x(l, x);
      }
      if (k < 64) bits |= 1ull << k;
    }
    gram.add(x, on, lane);
  }
#define DN_ON(k, l) (bits_ok ? ((bits >> (k)) & 1ull) != 0 : src.on(l))
  u_lane = red.refit(gram, 0, u_lane, power_cold, 0, ADAPT || nmf_iter == 0,
                     s);

  // merged sweeps: v = u^T X, multiplier update, Gram of the new X
  int ran = nmf_iter;
  for (int it = 0; it < nmf_iter; ++it) {
    u.set(u_lane, lane);
    gram.zero();
    for (int l0 = warp * 32, k = 0; l0 < nloc; l0 += nt, ++k) {
      const int l = l0 + lane;
      const bool on = DN_ON(k, l);
      float x[PMAX];
      if (on) {  // a column outside the mask stays exactly zero
        src.load_x(l, x);
        float v = 0.f;
#pragma unroll
        for (int i = 0; i < PMAX; ++i) v = fmaf(x[i], u[i], v);
        // ADAPT: est = K_i E_w with K = u s and E = v / (s + eps), taken as
        // u_i (s E_w), which differs from (u_i s) E_w in the last bit and
        // keeps the per-row work and registers of the default sweep
        const float se = ADAPT ? __fmul_rn(s, v / (s + DN_EPS)) : v;
        // X <- max(X - step * (est - A0), A0), A0 eight rows at a time
        // (all of them at p <= 8): registers are short at p = 32
#pragma unroll
        for (int i0 = 0; i0 < PMAX; i0 += 8) {
          constexpr int NC = PMAX < 8 ? PMAX : 8;
          float a[NC];
#pragma unroll
          for (int i = 0; i < NC; ++i) a[i] = src.a_at(l, i0 + i);
#pragma unroll
          for (int i = 0; i < NC; ++i)
            x[i0 + i] =
                fmaxf(x[i0 + i] - step * (u[i0 + i] * se - a[i]), a[i]);
        }
        src.store_x(l, x);
      }
      gram.add(x, on, lane);
    }
    if constexpr (ADAPT) {
      const float k_old = __fmul_rn(u_lane, s);
      u_lane = red.refit(gram, (it + 1) & 1, u_lane, power_warm, warm_plain,
                         true, s);
      const float k_new = __fmul_rn(u_lane, s);
      const float delta = warp_max(fabsf(k_new - k_old));
      const float ref = fmaxf(warp_max(fabsf(k_new)), DN_EPS);
      if (delta <= __fmul_rn(tol, ref)) {  // frozen: this update kept
        ran = it + 1;
        break;
      }
    } else {
      u_lane = red.refit(gram, (it + 1) & 1, u_lane, power_warm, warm_plain,
                         it == nmf_iter - 1, s);
    }
  }
  if (n_run != nullptr) *n_run = ran;

  // finish: E = X^T u / (s + eps), and this thread's share of its sum
  u.set(u_lane, lane);
  float se = 0.f;
  for (int l0 = warp * 32, k = 0; l0 < nloc; l0 += nt, ++k) {
    const int l = l0 + lane;
    float e = 0.f;
    if (DN_ON(k, l)) {
      float x[PMAX];
      src.load_x(l, x);
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < PMAX; ++i) v = fmaf(x[i], u[i], v);
      e = v / (s + DN_EPS);
    }
    src.store_e(l, e);
    se += e;
  }
#undef DN_ON
  return se;
}

// p -> template instantiation CALL(PMAX, FULL): the smallest PMAX that holds
// p, and whether p fills it
#define DN_DISPATCH_P(p, CALL) \
  do {                         \
    if ((p) == 4) {            \
      CALL(4, true);           \
    } else if ((p) < 4) {      \
      CALL(4, false);          \
    } else if ((p) == 8) {     \
      CALL(8, true);           \
    } else if ((p) < 8) {      \
      CALL(8, false);          \
    } else if ((p) == 16) {    \
      CALL(16, true);          \
    } else if ((p) < 16) {     \
      CALL(16, false);         \
    } else if ((p) == 32) {    \
      CALL(32, true);          \
    } else {                   \
      CALL(32, false);         \
    }                          \
  } while (0)
