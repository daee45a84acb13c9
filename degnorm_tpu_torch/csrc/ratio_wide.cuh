// Kernel 2 for 33 <= p <= 128 samples: ratio-SVD row sums in phases over
// the whole card, coverage read as it is stored (raw int16 or float32).
// The C entry point stays ratio.cu's dn_ratio_rowsums, which hands p > 32
// here; the instances are compiled in ratio_wide_f32.cu and
// ratio_wide_i16.cu, side by side.
//
// Replaces, for wide studies, the TPU kernel degnorm_tpu/ops/pallas_nmf.py::
// ratio_rowsums_pallas (_ratio_kernel), as ratio.cuh does for p <= 32:
// A0 = F * mask, one cold rank-1 (K, E), the row sums of A0 and of
// max(K (x) E, A0).  Bound on this card: float32 operations (the Gram's
// p(p+1)/2 products a column against 2p bytes of int16).
//
// A call runs the genes in groups of at most `ws_slots` (ops/cuda_nmf.py::
// ratio_wide_slots: a workspace of a bounded size), each gene of a group
// with its slot of the workspace, in four launches a group on the caller's
// stream:
//   1. the Gram (ratio_wide_gram_kernel, a block a (chunk, gene)): a gene's
//      columns are cut into chunks of DN_RW_CHUNK_TILES tiles of DN_WIDE_TC
//      (dn_rw_chunks: one for W <= 1,024, so a bucket of a few long genes
//      fills the card as a bucket of many short ones does).  A chunk's
//      tiles with an active column are listed first (a tile with none adds
//      nothing, which is exact), then copied as they are stored into a
//      ring of DN_RW_STAGES stages of shared memory, DN_RW_AHEAD tiles ahead
//      of the one worked on (cp.async, 16 bytes a copy), staged as float32
//      column by column (zeros off the mask), and summed into the Gram's
//      upper triangle (wide.cuh's WideTri and WideDiag, half the products of
//      the full register tile, a warp of off-diagonal blocks loading each
//      row once: half the block the tiles' even columns, half their odd
//      ones, the two sums added at the end) and into the row sums (each row
//      by dn_rw_rs(PMAX) threads, columns strided, their partials added in
//      order at the end); the chunk's partial Gram (with its mirror) and row
//      sums of A0 into the slot;
//   2. the power step, a block a gene (dn_rw_power_threads): B and the row
//      sums are the chunks' partials summed in chunk order (no float
//      atomics), B^2 of the normalised Gram in registers, then max(1,
//      power_cold / 4) bodies of two B^2 matvecs (each row's share four
//      partial sums in a fixed order) and a renormalisation, and s =
//      sqrt(max(u^T B u, 0)); u and s into the slot.  Up to PMAX 64 one or
//      two warps a gene (ratio_wide_power_warp_kernel: whole rows of B^2 in
//      a thread's registers, two a lane at PMAX 48, one at 64, each built
//      from Bn's rows in order of k, so an SM holds a dozen genes' serial
//      chains at once); past it 256 threads
//      (ratio_wide_power_kernel: B^2 by wide.cuh's register tile,
//      WideGram<PMAX>::syrk as wide_refit forms it, each row in the
//      registers of DN_RW_TR adjacent threads, their shares added by a
//      shuffle);
//   3. the second pass (ratio_wide_est_kernel, a block a (chunk, gene)), on
//      the same pipeline of listed tiles: e = A0^T u / (s + eps) of each
//      active column (the four quarters' partials in a fixed order), the
//      row sums of max(K e, A0) over the chunk's active columns;
//   4. where a gene has several chunks, their row sums in chunk order
//      (ratio_wide_sum_kernel).
// Each sum has one fixed order, so two runs give the same bits.  A value is
// (float)raw for int16, which is exact, and every operation after the load
// is the same for both forms in the same order, so int16 input gives the
// bits of float32 input holding the same values.  The second pass reads
// the gene's columns again, from L2 where the group's genes fit it.
#pragma once
#include "ratio.cuh"
#include "wide.cuh"

#define DN_RW_CHUNK_TILES 16  // tiles of DN_WIDE_TC columns a chunk
#define DN_RW_SCAL 4          // a slot's scalars: s, 3 free
#define DN_RW_AHEAD 2         // tiles copied ahead of the one worked on
#define DN_RW_STAGES (DN_RW_AHEAD + 1)

#define DN_RW_TR 2            // threads a row of B^2 past PMAX 64 (launch 2)

// Threads that sum each row of a tile (launches 1 and 3; 256 a block).
__host__ __device__ constexpr int dn_rw_rs(int pmax) {
  return pmax <= 64 ? 4 : 2;
}
// Threads of a gene's power step (launch 2): a warp at PMAX 48 (two rows
// of B^2 a lane), two at 64 (a row a lane), 256 past it (DN_RW_TR threads
// a row).
__host__ __device__ constexpr int dn_rw_power_threads(int pmax) {
  return pmax <= 48 ? 32 : pmax <= 64 ? 64 : DN_WIDE_THREADS;
}

// Chunks of a gene of W columns.
__host__ __device__ inline int dn_rw_chunks(int W) {
  const int tiles = (W + DN_WIDE_TC - 1) / DN_WIDE_TC;
  return tiles > DN_RW_CHUNK_TILES
             ? (tiles + DN_RW_CHUNK_TILES - 1) / DN_RW_CHUNK_TILES
             : 1;
}
// Floats of a gene's slot: each chunk's partial Gram (PMAX x PMAX; the
// first becomes B) and row sums (PMAX), u and the scalars.
__host__ __device__ inline size_t dn_rw_slot_floats(int pmax, int W) {
  return (size_t)dn_rw_chunks(W) * (pmax * pmax + pmax) + pmax + DN_RW_SCAL;
}
// Bytes of each launch's shared memory (esize: bytes an input element):
// the copy stages, the two float32 tiles (after launch 1's loop: B), the
// row sums' partials, the tile list and the chunk's mask bytes (launches 1
// and 3; launch 3 adds the v partials, u and K); launch 2's B, u, a matvec's result and 32
// floats of scratch.
__host__ __device__ constexpr int dn_rw_tiles_bytes(int pmax, int esize) {
  return DN_RW_STAGES * pmax * DN_WIDE_TC * esize +
         4 * (2 * DN_WIDE_TC * (pmax + 4) + 256 + DN_RW_CHUNK_TILES + 4) +
         DN_RW_CHUNK_TILES * DN_WIDE_TC;
}
__host__ __device__ constexpr int dn_rw_est_bytes(int pmax, int esize) {
  return dn_rw_tiles_bytes(pmax, esize) + 4 * (4 * DN_WIDE_TC + 2 * pmax);
}
__host__ __device__ constexpr int dn_rw_power_bytes(int pmax) {
  return 4 * (pmax * (pmax + 4) + 2 * pmax + 32);
}

// A gene's slot of the workspace.
template <int PMAX>
struct RwSlot {
  float* part;  // nch x PMAX x PMAX: the chunks' partial Grams (B in the first)
  float* rsp;   // nch x PMAX: the chunks' row sums (of A0, then of the est)
  float* u;     // PMAX
  float* scal;  // s
  __device__ __forceinline__ RwSlot(float* ws, int slot, int W) {
    const int nch = dn_rw_chunks(W);
    part = ws + (size_t)slot * dn_rw_slot_floats(PMAX, W);
    rsp = part + (size_t)nch * PMAX * PMAX;
    u = rsp + (size_t)nch * PMAX;
    scal = u + PMAX;
  }
};

template <int N>
__device__ __forceinline__ void rw_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The tiles of chunk `ch` of one gene through shared memory (launches 1 and
// 3): the chunk's tiles with an active column listed in order, each copied
// as stored into stage m % DN_RW_STAGES, then read by thread (q, c) as the
// float32 values of rows q Q .. q Q + Q - 1 of column c (zeros off the mask
// and past p).  Shared memory: the stages, then two float32 tiles of TC x
// LD (S), the row sums' partials (256 floats), the list and its count, the
// chunk's mask bytes (read once, from device memory, by list()).
template <int PMAX, class T>
struct RwTiles {
  static constexpr int TC = DN_WIDE_TC, LD = WideShape<PMAX>::LD;
  static constexpr int Q = WideShape<PMAX>::Q, V = 16 / sizeof(T);
  T* st;
  float* S;
  float* rsp;  // row sums' partials (dn_rw_rs(PMAX) x PMAX)
  int* tl;
  uint8_t* msk;  // the chunk's mask bytes (list)
  const T* F;
  const uint8_t* mg;
  int p, W, n, k0;
  bool vec;  // rows 16-byte aligned: cp.async copies
  __device__ __forceinline__ RwTiles(unsigned char* smem, const T* F_,
                                     const uint8_t* mg_, int p_, int W_)
      : F(F_), mg(mg_), p(p_), W(W_), n(0), k0(0) {
    st = (T*)smem;
    S = (float*)(smem + DN_RW_STAGES * PMAX * TC * sizeof(T));
    rsp = S + 2 * TC * LD;
    tl = (int*)(rsp + 256);
    msk = (uint8_t*)(tl + DN_RW_CHUNK_TILES + 4);
    vec = ((uintptr_t)F % 16 == 0) && (W % V == 0);
  }
  // The chunk's mask bytes (columns k0 TC .. k1 TC, zeros past W) into
  // msk, then the active tiles k0 <= k < k1 (at most DN_RW_CHUNK_TILES) in
  // order, by warp 0; ends with a barrier.  Returns their count.
  __device__ __forceinline__ int list(int k0_, int k1) {
    const int t = threadIdx.x;
    k0 = k0_;
    const int l0 = k0 * TC, nb = (k1 - k0) * TC;
    for (int j = t; j < nb; j += DN_WIDE_THREADS)
      msk[j] = l0 + j < W ? mg[l0 + j] : 0;
    __syncthreads();
    if (t < 32) {
      bool on = false;
      if (k0 + t < k1) {
        const uint32_t* m4 = (const uint32_t*)(msk + t * TC);
        uint32_t o = 0;
#pragma unroll
        for (int j = 0; j < TC / 4; ++j) o |= m4[j];
        on = o != 0;
      }
      const unsigned bal = __ballot_sync(DN_FULL, on);
      if (on) tl[__popc(bal & ((1u << t) - 1u))] = k0 + t;
      if (t == 0) tl[DN_RW_CHUNK_TILES] = __popc(bal);
    }
    __syncthreads();
    n = tl[DN_RW_CHUNK_TILES];
    return n;
  }
  // Copy list entry m (if any) into its stage, and commit a group (every
  // thread, every call: the group count stays uniform).
  __device__ __forceinline__ void issue(int m) {
    if (m < n) {
      const int l0 = tl[m] * TC;
      T* s = st + (m % DN_RW_STAGES) * PMAX * TC;
      if (vec) {
        for (int idx = threadIdx.x; idx < p * (TC / V);
             idx += DN_WIDE_THREADS) {
          const int i = idx / (TC / V), j = (idx % (TC / V)) * V;
          if (l0 + j < W)
            dn_cp_async16(s + i * TC + j, F + (size_t)i * W + l0 + j);
        }
      } else {
        for (int idx = threadIdx.x; idx < p * TC; idx += DN_WIDE_THREADS) {
          const int i = idx / TC, j = idx % TC;
          if (l0 + j < W) s[i * TC + j] = F[(size_t)i * W + l0 + j];
        }
      }
    }
    dn_cp_async_commit();
  }
  // Wait for list entry m's copy (DN_RW_AHEAD later ones may be in
  // flight), then a barrier: every thread's copies are visible.
  __device__ __forceinline__ void wait() const {
    rw_cp_async_wait<DN_RW_AHEAD>();
    __syncthreads();
  }
  // Thread (q, c)'s values of entry m: returns whether column c is active.
  __device__ __forceinline__ bool read(int m, float (&x)[Q]) const {
    const int t = threadIdx.x, q = t >> 6, c = t & (TC - 1), i0 = q * Q;
    const int k = tl[m], l = k * TC + c;
    const bool on = l < W && msk[(k - k0) * TC + c] != 0;
    const T* s = st + (m % DN_RW_STAGES) * PMAX * TC + c;
#pragma unroll
    for (int j = 0; j < Q; ++j)
      x[j] = (on && i0 + j < p) ? ratio_val(s[(i0 + j) * TC]) : 0.f;
    return on;
  }
  // x into tile S[b], column c's rows contiguous.
  __device__ __forceinline__ void stage(int b, const float (&x)[Q]) const {
    const int t = threadIdx.x, q = t >> 6, c = t & (TC - 1);
    float* Sc = S + b * TC * LD + c * LD + q * Q;
#pragma unroll
    for (int k4 = 0; k4 < Q; k4 += 4) {
      const float y[4] = {x[k4], x[k4 + 1], x[k4 + 2], x[k4 + 3]};
      wide_st<4>(Sc + k4, y);
    }
  }
  // This thread's share of the row sums of tile S[b]: row t % PMAX over
  // the columns t / PMAX, + RS, ... (t < RS PMAX).
  __device__ __forceinline__ void rowsum(int b, float& rs) const {
    constexpr int RS = dn_rw_rs(PMAX);
    const int t = threadIdx.x;
    if (t < RS * PMAX) {
      const float* Sb = S + b * TC * LD + t % PMAX;
#pragma unroll 4
      for (int kk = t / PMAX; kk < TC; kk += RS) rs += Sb[kk * LD];
    }
  }
  // The rows' sums: the RS partials of each row added in order; thread
  // t < PMAX gets row t's.  Starts and ends with a barrier.
  __device__ __forceinline__ float rowsums(float rs) const {
    constexpr int RS = dn_rw_rs(PMAX);
    const int t = threadIdx.x;
    __syncthreads();
    if (t < RS * PMAX) rsp[t] = rs;
    __syncthreads();
    float r = 0.f;
    if (t < PMAX) {
      r = rsp[t];
#pragma unroll
      for (int k = 1; k < RS; ++k) r += rsp[k * PMAX + t];
    }
    __syncthreads();
    return r;
  }
};

// The listed tiles of chunk ch: [k0, k1) of a gene of W columns.
__device__ __forceinline__ int rw_chunk_end(int W, int k0) {
  const int ntile = (W + DN_WIDE_TC - 1) / DN_WIDE_TC;
  return ntile - k0 < DN_RW_CHUNK_TILES ? ntile : k0 + DN_RW_CHUNK_TILES;
}

// Launch 1: block (ch, slot) the Gram and row sums of A0 over chunk ch of
// gene base + slot.  Threads t < 128 (half 0) take the listed tiles' even
// columns, 128 + g (half 1) their odd ones, each its R x R block of the
// triangle (or its two diagonal blocks' halves, WideTri) and, for g <
// PMAX / 2, a diagonal entry of an odd diagonal block (WideDiag's rows);
// each entry is then half 0's sum plus half 1's, stored with its mirror.
template <int PMAX, bool I16>
__global__ void __launch_bounds__(DN_WIDE_THREADS, dn_wide_min_blocks<PMAX>())
    ratio_wide_gram_kernel(RatioArgs a, int base) {
  using T = typename std::conditional<I16, int16_t, float>::type;
  constexpr int Q = WideShape<PMAX>::Q, LD = WideShape<PMAX>::LD;
  constexpr int R = WideShape<PMAX>::R, TC = DN_WIDE_TC;
  extern __shared__ float4 dyn4[];
  const int t = threadIdx.x, half = t >> 7, gt = t & 127;
  const int slot = blockIdx.y, ch = blockIdx.x, p = a.p, W = a.W;
  const size_t g = (size_t)base + slot;
  RwTiles<PMAX, T> tiles((unsigned char*)dyn4, (const T*)a.F + g * p * W,
                         a.mask + g * W, p, W);
  const int k0 = ch * DN_RW_CHUNK_TILES;
  const int n = tiles.list(k0, rw_chunk_end(W, k0));
  WideTri<PMAX> tri(gt);
  tri.zero();
  // a warp whose blocks are all off the diagonal (warp-uniform)
  const bool offdiag = (gt | 31) < DN_WIDE_TRI_PAIRS;
  const int drow = gt < PMAX / 2 ? ((gt / R) * 2 + 1) * R + gt % R : -1;
  float dacc = 0.f;  // an odd diagonal block's diagonal entry (drow)
  float rs = 0.f;
#pragma unroll
  for (int m = 0; m < DN_RW_AHEAD; ++m) tiles.issue(m);
  for (int m = 0; m < n; ++m) {
    // (the stage it fills was read in iteration m - 1, before a barrier)
    tiles.issue(m + DN_RW_AHEAD);
    tiles.wait();
    float x[Q];
    tiles.read(m, x);
    tiles.stage(m & 1, x);
    __syncthreads();
    const float* Sb = tiles.S + (m & 1) * TC * LD;
    tiles.rowsum(m & 1, rs);
    if (offdiag) {  // (rows A1 = A2, B1 = B2: one load each)
#pragma unroll 2
      for (int kk = half; kk < TC; kk += 2) {
        const float* Mk = Sb + kk * LD;
        float A[R], B[R];
        wide_ld<R>(Mk + tri.a1, A);
        wide_ld<R>(Mk + tri.b1, B);
#pragma unroll
        for (int rr = 0; rr < R; ++rr)
#pragma unroll
          for (int cc = 0; cc < R; ++cc)
            tri.acc[rr][cc] = fmaf(A[rr], B[cc], tri.acc[rr][cc]);
      }
    } else {
#pragma unroll 2
      for (int kk = half; kk < TC; kk += 2) tri.syrk_row(Sb + kk * LD);
    }
    if (drow >= 0)
      for (int kk = half; kk < TC; kk += 2) {
        const float xx = Sb[kk * LD + drow];
        dacc = fmaf(xx, xx, dacc);
      }
    // (S[m & 1] is written again in iteration m + 2, after two barriers)
  }
  const float rsum = tiles.rowsums(rs);  // (its barriers: S is free)
  // half 0's sums into shared memory (the tiles' place), half 1 adds its
  // own and writes the chunk's partial, each entry and its mirror once
  float* Bs = tiles.S;
  if (half == 0) {
    tri.store(Bs);
    if (drow >= 0) Bs[drow * LD + drow] = dacc;
  }
  __syncthreads();
  const RwSlot<PMAX> sl(a.ws, slot, W);
  float* M = sl.part + (size_t)ch * PMAX * PMAX;
  if (half == 1) {
#pragma unroll
    for (int rr = 0; rr < R; ++rr)
#pragma unroll
      for (int cc = 0; cc < R; ++cc) {
        int i, j;
        tri.entry(rr, cc, i, j);
        const float v = Bs[i * LD + j] + tri.acc[rr][cc];
        M[i * PMAX + j] = v;
        M[j * PMAX + i] = v;
      }
    if (drow >= 0) M[drow * PMAX + drow] = Bs[drow * LD + drow] + dacc;
  }
  if (t < PMAX) sl.rsp[ch * PMAX + t] = rsum;
}

// (B^2 x) of the RL rows whose B^2 entries a thread holds (b2[r]), x in
// shared memory: each four partial sums over j = 0, 1, 2, 3 mod 4 in order
// of j, then ((a0 + a1) + (a2 + a3)).
template <int PMAX, int RL>
__device__ __forceinline__ void rw_matvec_rows(const float (&b2)[RL][PMAX],
                                               const float* x,
                                               float (&y)[RL]) {
  float acc[RL][4];
#pragma unroll
  for (int r = 0; r < RL; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
#pragma unroll
  for (int j = 0; j < PMAX; j += 4) {
    const float4 xv = *(const float4*)(x + j);
#pragma unroll
    for (int r = 0; r < RL; ++r) {
      acc[r][0] = fmaf(b2[r][j], xv.x, acc[r][0]);
      acc[r][1] = fmaf(b2[r][j + 1], xv.y, acc[r][1]);
      acc[r][2] = fmaf(b2[r][j + 2], xv.z, acc[r][2]);
      acc[r][3] = fmaf(b2[r][j + 3], xv.w, acc[r][3]);
    }
  }
#pragma unroll
  for (int r = 0; r < RL; ++r)
    y[r] = (acc[r][0] + acc[r][1]) + (acc[r][2] + acc[r][3]);
}

// y_t = (B^2 x)_t of row t = threadIdx / TR, this thread's share h of its
// columns in registers (b2: columns h H .. h H + H - 1) and x in shared
// memory: four partial sums over j = 0, 1, 2, 3 mod 4 in order of j, then
// ((a0 + a1) + (a2 + a3)), the TR shares added by a butterfly of shuffles
// over adjacent lanes (the same bits in each).
template <int H, int TR>
__device__ __forceinline__ float rw_matvec(const float (&b2)[H],
                                           const float* xh) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int j = 0; j < H; j += 4) {
    const float4 xv = *(const float4*)(xh + j);
    a0 = fmaf(b2[j], xv.x, a0);
    a1 = fmaf(b2[j + 1], xv.y, a1);
    a2 = fmaf(b2[j + 2], xv.z, a2);
    a3 = fmaf(b2[j + 3], xv.w, a3);
  }
  float v = (a0 + a1) + (a2 + a3);
#pragma unroll
  for (int o = 1; o < TR; o <<= 1) v += __shfl_xor_sync(DN_FULL, v, o);
  return v;
}

// B (its chunks' partials summed in chunk order, into Bs at rows of LD
// floats, and back into the first partial where there are several) and
// the row sums of A0 of a slot's gene, by the block's NT threads.  Ends
// with a barrier.
template <int PMAX, int NT>
__device__ __forceinline__ void rw_load_gram(const RwSlot<PMAX>& sl,
                                             const RatioArgs& a, size_t g,
                                             float* Bs) {
  constexpr int LD = WideShape<PMAX>::LD;
  const int t = threadIdx.x, p = a.p, nch = dn_rw_chunks(a.W);
  for (int k = 4 * t; k < PMAX * PMAX; k += 4 * NT) {
    float4 v = *(const float4*)(sl.part + k);
    for (int ch = 1; ch < nch; ++ch) {
      const float4 w = *(const float4*)(sl.part + (size_t)ch * PMAX * PMAX + k);
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    *(float4*)(Bs + (k / PMAX) * LD + k % PMAX) = v;
    if (nch > 1) *(float4*)(sl.part + k) = v;
  }
  for (int i = t; i < PMAX; i += NT) {
    float v = sl.rsp[i];
    for (int ch = 1; ch < nch; ++ch) v += sl.rsp[ch * PMAX + i];
    if (i < p) a.cov[g * p + i] = v;
  }
  __syncthreads();
}

// The power step up to PMAX 64 (launch 2): RL rows of B^2 a thread (two
// at PMAX 48, one at 64), rows l, l + NL, ... of the gene's NL = PMAX / RL
// threads, in NT threads (one or two warps).
template <int PMAX>
struct RwPow {
  static constexpr int RL = PMAX <= 48 ? 2 : 1, NL = PMAX / RL;
  static constexpr int NT = (NL + 31) / 32 * 32, NW = NT / 32;
};

// The gene's threads in step (a warp's, or the block's barrier).
template <int NW>
__device__ __forceinline__ void rw_gene_sync() {
  if constexpr (NW == 1) __syncwarp();
  else __syncthreads();
}

// The sum (or the largest) of the gene's (the block's) threads' values,
// warps in order: the same in every thread.  `red` NW floats; ends in step.
template <int NW, bool MAX>
__device__ __forceinline__ float rw_gene_reduce(float* red, float v) {
  v = MAX ? warp_max(v) : warp_sum(v);
  if constexpr (NW == 1) return v;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int k = 1; k < NW; ++k) r = MAX ? fmaxf(r, red[k]) : r + red[k];
  __syncthreads();
  return r;
}

// Launch 2 up to PMAX 64: block `slot` the power step of gene base +
// slot, RwPow's rows of B^2 in each thread's registers (rows p .. PMAX - 1
// are zero throughout, which is exact).
template <int PMAX, bool I16>
__global__ void __launch_bounds__(RwPow<PMAX>::NT)
    ratio_wide_power_warp_kernel(RatioArgs a, int base) {
  using PW = RwPow<PMAX>;
  constexpr int LD = WideShape<PMAX>::LD, RL = PW::RL, NL = PW::NL;
  constexpr int NT = PW::NT, NW = PW::NW;
  extern __shared__ float4 dyn4[];
  float* Bs = (float*)dyn4;  // PMAX x LD: B, then Bn = B / (max|B| + eps)
  float* u = Bs + PMAX * LD;
  float* va = u + PMAX;
  float* red = va + PMAX;
  const int t = threadIdx.x, slot = blockIdx.x, p = a.p;
  const bool holds = t < NL;
  int row[RL];
#pragma unroll
  for (int r = 0; r < RL; ++r) row[r] = (holds ? t : 0) + r * NL;
  const size_t g = (size_t)base + slot;
  const RwSlot<PMAX> sl(a.ws, slot, a.W);
  rw_load_gram<PMAX, NT>(sl, a, g, Bs);
  float m = 0.f;
  for (int k = t; k < PMAX * PMAX; k += NT)
    m = fmaxf(m, fabsf(Bs[(k / PMAX) * LD + k % PMAX]));
  const float inv = 1.0f / (rw_gene_reduce<NW, true>(red, m) + DN_EPS);
  for (int k = t; k < PMAX * PMAX; k += NT) {
    float* b = Bs + (k / PMAX) * LD + k % PMAX;
    *b = *b * inv;
  }
  rw_gene_sync<NW>();
  // this thread's rows of B^2 of the normalised Gram (B is exactly
  // symmetric): sum over k of Bn[k][r] Bn[k][j], in order of k
  float b2[RL][PMAX];
#pragma unroll
  for (int r = 0; r < RL; ++r)
#pragma unroll
    for (int j = 0; j < PMAX; ++j) b2[r][j] = 0.f;
  for (int k = 0; k < PMAX; ++k) {
    const float* Bk = Bs + k * LD;
    float c[RL];
#pragma unroll
    for (int r = 0; r < RL; ++r) c[r] = Bk[row[r]];
#pragma unroll
    for (int j = 0; j < PMAX; j += 4) {
      const float4 bv = *(const float4*)(Bk + j);
#pragma unroll
      for (int r = 0; r < RL; ++r) {
        b2[r][j] = fmaf(c[r], bv.x, b2[r][j]);
        b2[r][j + 1] = fmaf(c[r], bv.y, b2[r][j + 1]);
        b2[r][j + 2] = fmaf(c[r], bv.z, b2[r][j + 2]);
        b2[r][j + 3] = fmaf(c[r], bv.w, b2[r][j + 3]);
      }
    }
  }
  if (holds)
#pragma unroll
    for (int r = 0; r < RL; ++r)
      u[row[r]] = row[r] < p ? 1.0f / sqrtf((float)p) : 0.f;
  rw_gene_sync<NW>();
  int n_bodies = a.power_cold / 4;
  if (n_bodies < 1) n_bodies = 1;
  for (int it = 0; it < n_bodies; ++it) {
    float y[RL];
    rw_matvec_rows<PMAX, RL>(b2, u, y);
    if (holds)
#pragma unroll
      for (int r = 0; r < RL; ++r) va[row[r]] = y[r];
    rw_gene_sync<NW>();
    rw_matvec_rows<PMAX, RL>(b2, va, y);
    float n2 = 0.f;
#pragma unroll
    for (int r = 0; r < RL; ++r) n2 = fmaf(y[r], y[r], n2);
    const float nrm = sqrtf(rw_gene_reduce<NW, false>(red, holds ? n2 : 0.f));
    if (nrm > DN_EPS && holds)
#pragma unroll
      for (int r = 0; r < RL; ++r) u[row[r]] = y[r] / (nrm + DN_EPS);
    rw_gene_sync<NW>();
  }
  // s = sqrt(max(u^T B u, 0)), B's rows from the first partial
  float ubu = 0.f;
#pragma unroll
  for (int r = 0; r < RL; ++r) {
    const float* Br = sl.part + row[r] * PMAX;
    float bu = 0.f;
#pragma unroll 4
    for (int j = 0; j < PMAX; j += 4) {
      const float4 v = *(const float4*)(Br + j);
      bu = fmaf(v.x, u[j], bu);
      bu = fmaf(v.y, u[j + 1], bu);
      bu = fmaf(v.z, u[j + 2], bu);
      bu = fmaf(v.w, u[j + 3], bu);
    }
    ubu = fmaf(u[row[r]], bu, ubu);
  }
  const float s =
      sqrtf(fmaxf(rw_gene_reduce<NW, false>(red, holds ? ubu : 0.f), 0.f));
  if (holds)
#pragma unroll
    for (int r = 0; r < RL; ++r) sl.u[row[r]] = u[row[r]];
  if (t == 0) sl.scal[0] = s;
}

// Launch 2 past PMAX 64: block `slot` the power step of gene base + slot
// (rows p .. PMAX - 1 are zero throughout, which is exact).
template <int PMAX, bool I16>
__global__ void __launch_bounds__(DN_WIDE_THREADS)
    ratio_wide_power_kernel(RatioArgs a, int base) {
  constexpr int NT = DN_WIDE_THREADS, LD = WideShape<PMAX>::LD;
  constexpr int TR = DN_RW_TR, H = PMAX / TR;
  extern __shared__ float4 dyn4[];
  float* Bs = (float*)dyn4;  // PMAX x LD: B, then B^2
  float* u = Bs + PMAX * LD;
  float* va = u + PMAX;
  float* red = va + PMAX;
  const int t = threadIdx.x, row = t / TR, h = t % TR, slot = blockIdx.x;
  const bool holds = row < PMAX;  // (PMAX 96: 192 of 256 threads)
  const int p = a.p;
  const size_t g = (size_t)base + slot;
  const RwSlot<PMAX> sl(a.ws, slot, a.W);
  rw_load_gram<PMAX, NT>(sl, a, g, Bs);
  float m = 0.f;
  for (int k = t; k < PMAX * PMAX; k += NT)
    m = fmaxf(m, fabsf(Bs[(k / PMAX) * LD + k % PMAX]));
  const float inv =
      1.0f / (rw_gene_reduce<NT / 32, true>(red, m) + DN_EPS);
  // B^2 of the normalised Gram, as wide_refit forms it
  WideGram<PMAX> gr;
  gr.zero();
  gr.template syrk<true>(Bs, PMAX, inv);
  __syncthreads();  // B is read before B^2 takes its place
  gr.store(Bs);
  if (t < PMAX) u[t] = t < p ? 1.0f / sqrtf((float)p) : 0.f;
  __syncthreads();
  float b2[H];
#pragma unroll
  for (int j = 0; j < H; j += 4) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (holds) v = *(const float4*)(Bs + row * LD + h * H + j);
    b2[j] = v.x;
    b2[j + 1] = v.y;
    b2[j + 2] = v.z;
    b2[j + 3] = v.w;
  }
  int n_bodies = a.power_cold / 4;
  if (n_bodies < 1) n_bodies = 1;
  for (int it = 0; it < n_bodies; ++it) {
    const float y = rw_matvec<H, TR>(b2, u + h * H);
    if (holds && h == 0) va[row] = y;
    __syncthreads();
    const float vb = rw_matvec<H, TR>(b2, va + h * H);
    const float nrm =
        sqrtf(rw_gene_reduce<NT / 32, false>(red, holds && h == 0 ? vb * vb
                                                                 : 0.f));
    if (nrm > DN_EPS && holds && h == 0) u[row] = vb / (nrm + DN_EPS);
    __syncthreads();
  }
  // s = sqrt(max(u^T B u, 0)), this thread's share of B's row from the
  // first partial
  float bu = 0.f;
  if (holds) {
    const float* Bt = sl.part + row * PMAX + h * H;
#pragma unroll 4
    for (int j = 0; j < H; j += 4) {
      const float4 bv = *(const float4*)(Bt + j);
      bu = fmaf(bv.x, u[h * H + j], bu);
      bu = fmaf(bv.y, u[h * H + j + 1], bu);
      bu = fmaf(bv.z, u[h * H + j + 2], bu);
      bu = fmaf(bv.w, u[h * H + j + 3], bu);
    }
  }
#pragma unroll
  for (int o = 1; o < TR; o <<= 1) bu += __shfl_xor_sync(DN_FULL, bu, o);
  const float ubu = holds && h == 0 ? u[row] * bu : 0.f;
  const float s =
      sqrtf(fmaxf(rw_gene_reduce<NT / 32, false>(red, ubu), 0.f));
  if (t < PMAX) sl.u[t] = u[t];
  if (t == 0) sl.scal[0] = s;
}

// Launch 3: block (ch, slot) the row sums of max(K e, A0) over chunk ch of
// gene base + slot, on launch 1's pipeline of listed tiles: e = v / (s +
// eps) of each active column, v its four quarters' partials in order; one
// chunk writes est, several their partials.
template <int PMAX, bool I16>
__global__ void __launch_bounds__(DN_WIDE_THREADS)
    ratio_wide_est_kernel(RatioArgs a, int base) {
  using T = typename std::conditional<I16, int16_t, float>::type;
  constexpr int Q = WideShape<PMAX>::Q, TC = DN_WIDE_TC;
  extern __shared__ float4 dyn4[];
  const int t = threadIdx.x, q = t >> 6, c = t & (TC - 1), i0 = q * Q;
  const int slot = blockIdx.y, ch = blockIdx.x, p = a.p, W = a.W;
  const size_t g = (size_t)base + slot;
  RwTiles<PMAX, T> tiles((unsigned char*)dyn4, (const T*)a.F + g * p * W,
                         a.mask + g * W, p, W);
  float* vpart = (float*)((unsigned char*)dyn4 +
                          dn_rw_tiles_bytes(PMAX, sizeof(T)));  // 4 x TC
  float* u = vpart + 4 * TC;   // PMAX
  float* Kv = u + PMAX;        // PMAX: K = u s (zero beyond p)
  const RwSlot<PMAX> sl(a.ws, slot, W);
  const float s = sl.scal[0];
  if (t < PMAX) {
    u[t] = sl.u[t];
    Kv[t] = sl.u[t] * s;
  }
  const float den = s + DN_EPS;
  const int k0 = ch * DN_RW_CHUNK_TILES;
  const int n = tiles.list(k0, rw_chunk_end(W, k0));  // (u, K visible)
  float es = 0.f;
#pragma unroll
  for (int m = 0; m < DN_RW_AHEAD; ++m) tiles.issue(m);
  for (int m = 0; m < n; ++m) {
    tiles.issue(m + DN_RW_AHEAD);
    tiles.wait();
    float x[Q];
    const bool on = tiles.read(m, x);
    float vp = 0.f;
#pragma unroll
    for (int j = 0; j < Q; ++j) vp = fmaf(x[j], u[i0 + j], vp);
    vpart[q * TC + c] = vp;
    __syncthreads();
    if (on) {
      const float v = ((vpart[c] + vpart[TC + c]) + vpart[2 * TC + c]) +
                      vpart[3 * TC + c];
      const float e = v / den;
#pragma unroll
      for (int j = 0; j < Q; ++j)
        x[j] = i0 + j < p ? fmaxf(Kv[i0 + j] * e, x[j]) : 0.f;
    }
    tiles.stage(m & 1, x);
    __syncthreads();
    tiles.rowsum(m & 1, es);
    // (vpart is written again after the next iteration's first barrier,
    // S[m & 1] after two)
  }
  const float esum = tiles.rowsums(es);
  if (dn_rw_chunks(W) == 1) {
    if (t < p) a.est[g * p + t] = esum;
  } else if (t < PMAX) {
    sl.rsp[ch * PMAX + t] = esum;
  }
}

// Launch 4 (genes of several chunks): est of gene base + blockIdx.x, thread
// t < p its chunks' row sums in chunk order.
template <int PMAX, bool I16>
__global__ void __launch_bounds__(PMAX)
    ratio_wide_sum_kernel(RatioArgs a, int base) {
  const int t = threadIdx.x, slot = blockIdx.x, p = a.p;
  const int nch = dn_rw_chunks(a.W);
  const size_t g = (size_t)base + slot;
  const RwSlot<PMAX> sl(a.ws, slot, a.W);
  if (t >= p) return;
  float v = sl.rsp[t];
  for (int ch = 1; ch < nch; ++ch) v += sl.rsp[ch * PMAX + t];
  a.est[g * p + t] = v;
}

template <class Kern>
static int rw_launch(Kern kern, dim3 grid, int threads, size_t dyn,
                     const RatioArgs& a, int base) {
  if (dyn > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, threads, dyn, a.st>>>(a, base);
  return (int)cudaGetLastError();
}

template <int PMAX, bool I16>
static int launch_ratio_wide_at(const RatioArgs& a) {
  constexpr int ES = I16 ? 2 : 4;
  const int nch = dn_rw_chunks(a.W);
  int e = 0;
  for (int base = 0; e == 0 && base < a.G; base += a.ws_slots) {
    const unsigned n =
        (unsigned)(a.G - base < a.ws_slots ? a.G - base : a.ws_slots);
    e = rw_launch(ratio_wide_gram_kernel<PMAX, I16>, dim3(nch, n),
                  DN_WIDE_THREADS, dn_rw_tiles_bytes(PMAX, ES), a, base);
    if (e == 0) {
      if constexpr (PMAX <= 64)
        e = rw_launch(ratio_wide_power_warp_kernel<PMAX, I16>, dim3(n),
                      dn_rw_power_threads(PMAX), dn_rw_power_bytes(PMAX), a,
                      base);
      else
        e = rw_launch(ratio_wide_power_kernel<PMAX, I16>, dim3(n),
                      DN_WIDE_THREADS, dn_rw_power_bytes(PMAX), a, base);
    }
    if (e == 0)
      e = rw_launch(ratio_wide_est_kernel<PMAX, I16>, dim3(nch, n),
                    DN_WIDE_THREADS, dn_rw_est_bytes(PMAX, ES), a, base);
    if (e == 0 && nch > 1)
      e = rw_launch(ratio_wide_sum_kernel<PMAX, I16>, dim3(n), PMAX, 0, a,
                    base);
  }
  return e;
}

// ws: ws_slots slots of dn_rw_slot_floats(PMAX, W) floats (the genes of a
// group).
template <bool I16>
int launch_ratio_wide(const RatioArgs& a) {
  if (a.threads != DN_WIDE_THREADS || a.cl != 1 || a.p < DN_WIDE_MIN_P ||
      a.p > DN_WIDE_MAX_P || a.W < 1)
    return (int)cudaErrorInvalidValue;
  if (a.G == 0) return 0;
  if (a.ws == nullptr || a.ws_slots < 1) return (int)cudaErrorInvalidValue;
#define CALL(PM)                                         \
  do {                                                   \
    const int e = launch_ratio_wide_at<PM, I16>(a);      \
    if (e != 0) return e;                                \
  } while (0)
  DN_DISPATCH_WIDE_P(a.p, CALL);
#undef CALL
  return (int)cudaGetLastError();
}
