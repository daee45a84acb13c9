// Kernels 4c and 2c for 33 <= p <= 128 samples: the NMF-OA loop and the
// ratio-SVD row sums of a COLUMN-SHARDED gene bucket, cut at their
// reductions as stream_cols.cuh cuts them at p <= 32.  The C entry points
// stay stream_cols.cu's and ratio_cols.cu's, which hand p > 32 here; the
// instances are compiled in stream_cols_wide_<f32|i16|tol>.cu and
// ratio_cols_wide.cu, side by side.
//
// Replaces no Pallas kernel: on a mesh the JAX package runs a
// column-sharded bucket on its XLA path at any number of samples
// (degnorm_tpu/engine.py:75-84, :409-426), with GSPMD's all-reduce at each
// reduction point.  What is computed is stream_cols.cuh's: (a) X = A0 and
// the partial Gram of A0 over the shard; (b) once an iteration the S
// shards' partials summed, the power step, one merged sweep and the next
// partial; (c) the last sum, u, s, K and E; kernel 2c the cold power step
// on its first launch's summed partials and the row sums of A0 and of
// max(K e, A0).
//
// What bounds it on this card: bytes.  A launch a sweep sends a shard's X
// through device memory every sweep (4 bytes read and 4 written an
// element) with A0 read again (2 or 4), against the Gram's p(p+1)/2 fmas a
// column.  The layout (the second design; the first, a block's tiles
// staged in lockstep with the power step in every block, ran 11.7-12x its
// bound):
//   * the power step runs once a gene a launch (wcols_refit_kernel, a block
//     of 256 threads a gene): the S shards' packed partials summed in shard
//     order with plain float32 adds (ColumnGroup.combine's bits), then
//     wide.cuh's wide_refit (B^2 as a register tile, matvecs reduced by a
//     fixed butterfly, norms summed by each thread in one order) and, under
//     ADAPT, the freeze test; u, s, K and the frozen flags go to device
//     memory and a frozen or inactive gene's partial is zeroed there.  Every
//     shard (and every process) runs it on the same gathered bits, so u and
//     s are bit-equal everywhere, whatever the sweep's geometry;
//   * the sweep blocks (G x nb, pick_cols_geometry: a gene's chunks of
//     DN_STREAM_CHUNK dealt round robin, at most DN_WCR_MAX_TILES tiles of
//     DN_WIDE_TC a block) are warp-specialised: warp 8 is the producer, which
//     streams the block's tiles that hold an active column through a ring
//     of NS stages of half a tile (DN_WCR_HC columns of every row of X and
//     of A0 as stored) in shared memory, by 16-byte cp.async copies whose
//     landing each lane arrives on the stage's full mbarrier where the rows
//     are 16-byte aligned (W % 8 == 0), else by its own loads; warps 0-7
//     (the consumers, thread (q = t / 64, c = t % 64): rows q Q .. q Q + Q -
//     1 of column c) take a tile from its two stages: v = u^T x (the
//     quarters' partials summed in a fixed order), the update four rows at a
//     time, X written back to device memory at once, the tile into one of
//     two float32 tiles S (column c's rows contiguous), the stages handed
//     back (empty mbarrier), then the tile's Gram while the producer has the
//     next stages in flight;
//   * the Gram's upper triangle on the tensor cores (WcrMma: 3xTF32, the
//     split and mma of wide_res.cuh, lo lo dropped), each 16 x 8 fragment a
//     warp's over the block's columns in one chain, the two groups of four
//     warps (the tile's even and odd 8-column steps) added in group order;
//   * a block's chain is at most DN_WCR_MAX_TILES x DN_WIDE_TC =
//     COLS_WIDE_BLOCK_COLS columns; the blocks' packed partials meet in
//     block order through the gene's integer ticket (cols_gene_store), the
//     shards' in shard order in the next refit.  No float atomics: the same
//     bits for the same geometry, and on every shard;
//   * kernel 2c: the cold refit (the same kernel, from 1 / sqrt(p)) writes
//     u, s and K = u s; the row-sum pass streams A0 through the same ring,
//     thread (q, c) keeps its rows' sums of A0 and of max(K e, A0) over its
//     column of each tile (e = v / (s + eps)), then the block's 64 columns
//     are summed a row in column order, then the blocks' in block order, then
//     the shards' (a few hundred adds a value: a row summed over all of a
//     block's columns in one chain drifted 1.1e-5 from the plain version at
//     64 x 33 x 65,536).
// Shared memory (wcr_dyn_bytes): the ring, the two tiles S (after the loop
// the block's Gram and, in the ring's place, its packed partial), the v
// partials, u, K, the scales, the mbarriers, the tile list and the dealt
// columns' mask bytes; NS (wcr_stages) as many half-tile stages (8, 6 or 4)
// as leave two blocks an SM at PMAX <= 64 and one past it.
#pragma once

#include "stream_cols.cuh"
#include "wide.cuh"
#include "wide_res.cuh"  // dn_tf32, dn_mma_tf32, ResMma, res_unit

#define DN_WCR_CONSUMERS 256  // warps 0-7: the tiles' arithmetic and Gram
#define DN_WCR_THREADS 288    // ... and warp 8, the producer
#define DN_WCR_HC 32          // columns of a stage (half a tile)
#define DN_WCR_MAX_TILES 16   // tiles a block is dealt at most (1,024 columns)
#define DN_WCR_BAR 1          // named barrier of the consumers
#define DN_WCR_SMEM_SM 233472  // shared memory of an SM (1 KB of it a block's)

// Blocks an SM: two at PMAX <= 64, else one.
__host__ __device__ constexpr int wcr_blocks(int pmax) {
  return pmax <= 64 ? 2 : 1;
}
// Bytes of a stage: DN_WCR_HC columns of PMAX rows of X (float32) and of A0
// (esize bytes an element).
__host__ __device__ constexpr int wcr_stage_bytes(int pmax, int esize) {
  return pmax * DN_WCR_HC * (4 + esize);
}
// Floats a column of a tile S: PMAX rows and 8 more, so that a warp's
// tensor-core fragment loads (lanes g + 8 t4 of a row block) fall in 32
// banks.
__host__ __device__ constexpr int wcr_ld(int pmax) { return pmax + 8; }
// Bytes of the rest: the two tiles S, the v partials, u, K, the scales and
// their reciprocals, 2 ns mbarriers, the tile list and its count, the mask
// bytes of the dealt columns.
__host__ __device__ constexpr int wcr_fixed_bytes(int pmax, int ns) {
  return 4 * (2 * DN_WIDE_TC * wcr_ld(pmax) + 4 * DN_WIDE_TC + 4 * pmax) +
         16 * ns + 4 * (DN_WCR_MAX_TILES + 4) +
         DN_WCR_MAX_TILES * DN_WIDE_TC;
}
__host__ __device__ constexpr int wcr_dyn_bytes(int pmax, int esize, int ns) {
  return ns * wcr_stage_bytes(pmax, esize) + wcr_fixed_bytes(pmax, ns);
}
// Dynamic shared memory a block may take: the SM's share of each of its
// blocks, 1 KB left for the static.
__host__ __device__ constexpr int wcr_budget(int pmax) {
  return (wcr_blocks(pmax) == 1 ? DN_SMEM_BLOCK
                                : DN_WCR_SMEM_SM / 2 - 1024) -
         1024;
}
// Stages of the ring: 8, 6 or 4, the most the budget holds.
__host__ __device__ constexpr int wcr_stages(int pmax, int esize) {
  return wcr_dyn_bytes(pmax, esize, 8) <= wcr_budget(pmax)   ? 8
         : wcr_dyn_bytes(pmax, esize, 6) <= wcr_budget(pmax) ? 6
                                                             : 4;
}

// Index of the Gram's entry (i, j), i <= j, in a gene's packed partial.
template <int PMAX>
__device__ __forceinline__ int wcols_tri(int i, int j) {
  return i * PMAX - i * (i - 1) / 2 + (j - i);
}

// ---- mbarriers and cp.async copies ------------------------------------------
__device__ __forceinline__ unsigned wcr_smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void wcr_mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(wcr_smem(bar)),
               "r"(count)
               : "memory");
}
// the inits visible to the copies' arrivals (a block is a cluster of one)
__device__ __forceinline__ void wcr_mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void wcr_mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(wcr_smem(bar))
      : "memory");
}
__device__ __forceinline__ bool wcr_mbar_try(uint64_t* bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok)
      : "r"(wcr_smem(bar)), "r"(parity)
      : "memory");
  return ok != 0u;
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void wcr_mbar_wait(uint64_t* bar, unsigned parity) {
  while (!wcr_mbar_try(bar, parity)) {
  }
}
// 16 bytes (both ends 16-byte aligned) from device memory into shared
// memory by cp.async
__device__ __forceinline__ void wcr_cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(wcr_smem(dst)),
               "l"(src)
               : "memory");
}
// this thread's arrival on `bar` once its cp.async copies so far have
// landed (counted in the barrier's arrivals: .noinc)
__device__ __forceinline__ void wcr_cp_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   wcr_smem(bar))
               : "memory");
}
// the consumers' barrier (warps 0-7)
__device__ __forceinline__ void wcr_cbar() {
  dn_bar_sync(DN_WCR_BAR, DN_WCR_CONSUMERS);
}

// ---- a sweep block: its share of a gene, its ring ---------------------------
template <int PMAX, bool I16>
struct WcrBlock {
  using A = typename std::conditional<I16, int16_t, float>::type;
  static constexpr int TC = DN_WIDE_TC, HC = DN_WCR_HC, CH = DN_STREAM_CHUNK;
  static constexpr int LD = wcr_ld(PMAX);
  static constexpr int NS = wcr_stages(PMAX, (int)sizeof(A));
  static_assert(NS % 2 == 0 && NS >= 4, "a tile's two stages share a phase");
  float* stx;  // NS x PMAX x HC: a stage's X rows ...
  A* sta;      // ... and its A0 rows, as stored
  float* S;    // 2 x TC x LD: tiles, column c's rows contiguous
  float* vpart;  // 4 x TC: the quarters' partials of v
  float* u;      // PMAX (zero beyond p)
  float* Kv;     // PMAX: kernel 2c's K
  float* ss;     // 2 x PMAX: the scales, then their reciprocals
  uint64_t* full;   // NS: the stage's copies have landed
  uint64_t* empty;  // NS: the consumers are done with the stage
  int* tl;          // the listed tiles, their count at DN_WCR_MAX_TILES
  uint8_t* msk;     // the dealt slots' mask bytes (0 past the share or W)
  const A* F;
  float* X;
  const uint8_t* mg;
  int p, W, rank, nb, nloc, n;
  bool vec;

  __device__ __forceinline__ explicit WcrBlock(unsigned char* base) {
    stx = (float*)base;
    sta = (A*)(base + (size_t)NS * PMAX * HC * 4);
    S = (float*)(base + (size_t)NS * wcr_stage_bytes(PMAX, sizeof(A)));
    vpart = S + 2 * TC * LD;
    u = vpart + 4 * TC;
    Kv = u + PMAX;
    ss = Kv + PMAX;
    full = (uint64_t*)(ss + 2 * PMAX);
    empty = full + NS;
    tl = (int*)(empty + NS);
    msk = (uint8_t*)(tl + DN_WCR_MAX_TILES + 4);
  }
  // local slot l: column ((l / CH) nb + rank) CH + l % CH of the shard
  __device__ __forceinline__ int col(int l) const {
    return ((l / CH) * nb + rank) * CH + (l % CH);
  }
  // The scales of the int16 form (ones without `scale`) and u (zero beyond
  // p; cold: 1 / sqrt(p)); thread t < PMAX.  begin's barriers publish them.
  __device__ __forceinline__ void setup(const float* scale, const float* ug,
                                        int p_) {
    const int t = threadIdx.x;
    if (t < PMAX) {
      const float sv = (scale != nullptr && t < p_) ? scale[t] : 1.0f;
      ss[t] = sv;
      ss[PMAX + t] = 1.0f / sv;
      u[t] = t < p_ ? (ug != nullptr ? ug[t] : 1.0f / sqrtf((float)p_)) : 0.f;
    }
  }
  // The gene's view, the first nch chunks dealt (rank, rank + nb, ...),
  // their mask bytes, the mbarriers, the tiles with an active column in
  // order.  Whole block; ends with a barrier.
  __device__ __forceinline__ void begin(const void* F_, const uint8_t* mask,
                                        float* X_, size_t g, int p_, int W_,
                                        int rank_, int nb_, int nch) {
    const int t = threadIdx.x;
    p = p_;
    W = W_;
    rank = rank_;
    nb = nb_;
    F = F_ == nullptr ? nullptr : (const A*)F_ + g * p * W;
    X = X_ == nullptr ? nullptr : X_ + g * p * W;
    mg = mask + g * W;
    vec = W % 8 == 0 && (((uintptr_t)F | (uintptr_t)X) % 16) == 0;
    nloc = (rank < nch ? (nch - rank + nb - 1) / nb : 0) * CH;
    for (int l = t; l < DN_WCR_MAX_TILES * TC; l += blockDim.x) {
      bool on = false;
      if (l < nloc) {
        const int w = col(l);
        on = w < W && mg[w] != 0;
      }
      msk[l] = on;
    }
    if (t == 0) {
      for (int s = 0; s < NS; ++s) {
        wcr_mbar_init(full + s, 32);  // the producer's lanes
        wcr_mbar_init(empty + s, 1);  // consumer thread 0
      }
      wcr_mbar_fence_init();
    }
    __syncthreads();
    if (t < 32) {
      bool on = false;
      if (t < nloc / TC) {
        const uint32_t* m4 = (const uint32_t*)(msk + t * TC);
        uint32_t o = 0;
#pragma unroll
        for (int j = 0; j < TC / 4; ++j) o |= m4[j];
        on = o != 0;
      }
      const unsigned bal = __ballot_sync(DN_FULL, on);
      if (on) tl[__popc(bal & ((1u << t) - 1u))] = t;
      if (t == 0) tl[DN_WCR_MAX_TILES] = __popc(bal);
    }
    __syncthreads();
    n = tl[DN_WCR_MAX_TILES];
  }
  // The producer (warp 8): stage j % NS takes half j & 1 of listed tile
  // j / 2 once the consumers have handed it back, X rows too where WANT_X.
  template <bool WANT_X>
  __device__ __forceinline__ void produce() const {
    const int lane = threadIdx.x & 31;
    for (int j = 0; j < 2 * n; ++j) {
      const int s = j % NS;
      if (j >= NS) wcr_mbar_wait(empty + s, ((j / NS) - 1) & 1);
      const int w0 = col(tl[j >> 1] * TC + (j & 1) * HC);
      const int valid = W - w0 >= HC ? HC : (W - w0 > 0 ? W - w0 : 0);
      float* dx = stx + s * PMAX * HC;
      A* da = sta + s * PMAX * HC;
      if (vec) {  // 16-byte copies, whole ones (valid % 8 == 0)
        constexpr int XV = 4, AV = 16 / (int)sizeof(A);  // elements a copy
        if (WANT_X)
          for (int k = lane; k < p * (HC / XV); k += 32) {
            const int i = k / (HC / XV), c = (k % (HC / XV)) * XV;
            if (c < valid)
              wcr_cp16(dx + i * HC + c, X + (size_t)i * W + w0 + c);
          }
        for (int k = lane; k < p * (HC / AV); k += 32) {
          const int i = k / (HC / AV), c = (k % (HC / AV)) * AV;
          if (c < valid)
            wcr_cp16(da + i * HC + c, F + (size_t)i * W + w0 + c);
        }
        wcr_cp_arrive(full + s);
      } else {  // rows not 16-byte aligned: the lanes' own loads
        for (int k = lane; k < p * HC; k += 32) {
          const int i = k / HC, c = k % HC;
          if (c < valid) {
            if (WANT_X) dx[i * HC + c] = X[(size_t)i * W + w0 + c];
            da[i * HC + c] = F[(size_t)i * W + w0 + c];
          }
        }
        wcr_mbar_arrive(full + s);
      }
    }
  }
  // Consumer (q, c): wait for its half of listed tile m; its column's X
  // and A0 rows in that stage.
  __device__ __forceinline__ int wait_tile(int m) const {
    const int j = 2 * m + ((threadIdx.x & (TC - 1)) >> 5), s = j % NS;
    wcr_mbar_wait(full + s, (j / NS) & 1);
    return s;
  }
  // After a consumers' barrier that ends every read of tile m's stages.
  __device__ __forceinline__ void release_tile(int m) const {
    if (threadIdx.x == 0) {
      wcr_mbar_arrive(empty + (2 * m) % NS);
      wcr_mbar_arrive(empty + (2 * m + 1) % NS);
    }
  }
  // an A0 element as stored, as kernel 4c's float32 (scaled_i16) ...
  __device__ __forceinline__ float a0(A a, int i) const {
    if constexpr (I16) return scaled_i16(a, ss[i], ss[PMAX + i]);
    else return a;
  }
  // ... and as kernel 2c's coverage
  __device__ __forceinline__ float raw(A a) const { return (float)a; }
};

// The Gram's upper triangle on the tensor cores (3xTF32: wide_res.cuh's
// split of each value into hi = tf32(x) and lo = tf32(x - hi) and its
// products lo hi + hi lo + hi hi, the lo lo term dropped): the triangle's
// T (T + 1) fragments of 16 x 8 (T = PMAX / 16 row blocks; res_unit's
// order) dealt to the four warps of each of two groups in turn, group
// w >> 2 taking the tile's 8-column steps w >> 2, (w >> 2) + 2, ...; every
// fragment sums the block's columns in one chain.  The two groups' sums are
// added in group order at the end (wcr_pack).
template <int PMAX>
struct WcrMma {
  using M = ResMma<PMAX>;
  static constexpr int T = M::T, NU = M::NU, LD = wcr_ld(PMAX);
  static constexpr int TC = DN_WIDE_TC;
  static_assert(M::NKG == 2 && M::WPG == 4, "eight consumer warps");
  float acc[NU][4];
  __device__ __forceinline__ WcrMma() {
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
  }
  template <int WIG>
  __device__ __forceinline__ void add_w(const float* Sb, int grp) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll 1
    for (int ks = grp; ks < TC / 8; ks += M::NKG) {
      // rows 16 I + g and + 8 of columns 8 ks + t4 and + 4: the A
      // fragment's (a0, a1, a2, a3) of row block I
      const float* xk = Sb + (8 * ks + t4) * LD + g;
      uint32_t hi[T][4], lo[T][4];
#pragma unroll
      for (int I = 0; I < T; ++I) {
        const float v[4] = {xk[16 * I], xk[16 * I + 8], xk[4 * LD + 16 * I],
                            xk[4 * LD + 16 * I + 8]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hi[I][e] = dn_tf32(v[e]);
          lo[I][e] = dn_tf32(v[e] - __uint_as_float(hi[I][e]));
        }
      }
      // the small terms first; strip c's B fragment is half h = c % 2 of
      // row block c / 2's A fragment
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          const int I = res_unit<PMAX, WIG>(u, false);
          const int c = res_unit<PMAX, WIG>(u, true);
          if (I < 0) continue;
          const int J = c / 2, h = c % 2;
          const uint32_t(&a)[4] = term == 0 ? lo[I] : hi[I];
          const uint32_t(&b)[4] = term == 1 ? lo[J] : hi[J];
          dn_mma_tf32(acc[u], a[0], a[1], a[2], a[3], b[h], b[2 + h]);
        }
    }
  }
  __device__ __forceinline__ void add(const float* Sb) {
    const int w = threadIdx.x >> 5, grp = w >> 2;
    switch (w & 3) {
      case 0: add_w<0>(Sb, grp); break;
      case 1: add_w<1>(Sb, grp); break;
      case 2: add_w<2>(Sb, grp); break;
      default: add_w<3>(Sb, grp); break;
    }
  }
  // group 0 stores its entries into Bs (PMAX x LDB, before the barrier),
  // group 1 adds its own to them into the packed triangle pk (after it)
  template <int WIG>
  __device__ __forceinline__ void put_w(float* Bs, float* pk,
                                        bool second) const {
    constexpr int LDB = WideShape<PMAX>::LD;
    const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int I = res_unit<PMAX, WIG>(u, false);
      const int c = res_unit<PMAX, WIG>(u, true);
      if (I < 0) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * I + g + 8 * (e >> 1), j = 8 * c + 2 * t4 + (e & 1);
        if (!second)
          Bs[i * LDB + j] = acc[u][e];
        else if (i <= j)
          pk[wcols_tri<PMAX>(i, j)] = Bs[i * LDB + j] + acc[u][e];
      }
    }
  }
  __device__ __forceinline__ void put(float* Bs, float* pk,
                                      bool second) const {
    switch ((threadIdx.x >> 5) & 3) {
      case 0: put_w<0>(Bs, pk, second); break;
      case 1: put_w<1>(Bs, pk, second); break;
      case 2: put_w<2>(Bs, pk, second); break;
      default: put_w<3>(Bs, pk, second); break;
    }
  }
};

// The block's packed partial (NG floats) into `pk` from the tensor cores'
// two groups, Bs (PMAX x LD floats) between them.  Whole block, after a
// barrier that ends the reads of Bs's place; ends with a barrier.
template <int PMAX>
__device__ __forceinline__ void wcr_pack(const WcrMma<PMAX>& gr, float* Bs,
                                         float* pk) {
  const int t = threadIdx.x;
  if (t < DN_WCR_CONSUMERS / 2) gr.put(Bs, pk, false);
  __syncthreads();
  if (t >= DN_WCR_CONSUMERS / 2 && t < DN_WCR_CONSUMERS)
    gr.put(Bs, pk, true);
  __syncthreads();
}

// (a), and kernel 2c's first launch (X == nullptr): X = A0 over every chunk
// the block is dealt of the whole shard and its partial Gram; `ncols`
// (zeroed by the caller) receives the gene's last active column + 1.
template <int PMAX, bool I16>
__global__ void __launch_bounds__(DN_WCR_THREADS, wcr_blocks(PMAX))
    wcols_gram_kernel(const void* __restrict__ F,
                      const uint8_t* __restrict__ mask,
                      const uint8_t* __restrict__ act,
                      const float* __restrict__ scale, float* X,
                      float* __restrict__ gram, float* bpart, int* tickets,
                      int* ncols, int p, int W, int nb) {
  using Blk = WcrBlock<PMAX, I16>;
  constexpr int NG = cols_ng<PMAX>(), Q = WideShape<PMAX>::Q;
  constexpr int LD = Blk::LD, TC = DN_WIDE_TC, HC = DN_WCR_HC;
  extern __shared__ float4 dyn4[];
  const ColsBlock b(nb);
  const size_t g = b.g;
  const int t = threadIdx.x;
  float* out = gram + g * NG;
  if (act != nullptr && act[g] == 0) {
    if (b.rank == 0)
      for (int k = t; k < NG; k += blockDim.x) out[k] = 0.f;
    return;
  }
  Blk blk((unsigned char*)dyn4);
  blk.setup(scale, nullptr, p);
  blk.begin(F, mask, X, g, p, W, b.rank, nb,
            (W + DN_STREAM_CHUNK - 1) / DN_STREAM_CHUNK);
  int last = 0;
  for (int l = t; l < blk.nloc; l += blockDim.x)
    if (blk.msk[l]) last = max(last, blk.col(l) + 1);
  // an integer max: the same whatever the order
  last = __reduce_max_sync(DN_FULL, last);
  if ((t & 31) == 0 && last > 0) atomicMax(ncols + g, last);
  WcrMma<PMAX> gr;
  if (t >= DN_WCR_CONSUMERS) {
    blk.template produce<false>();
  } else {
    const int q = t >> 6, c = t & (TC - 1), i0 = q * Q;
    for (int m = 0; m < blk.n; ++m) {
      const int s = blk.wait_tile(m);
      const int l = blk.tl[m] * TC + c;
      const bool on = blk.msk[l] != 0;
      const typename Blk::A* ha = blk.sta + s * PMAX * HC + (c & 31);
      float* Xc = on && X != nullptr ? blk.X + blk.col(l) : nullptr;
      float x[Q];
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        const int i = i0 + k;
        x[k] = (on && i < p) ? blk.a0(ha[i * HC], i) : 0.f;
        if (Xc != nullptr && i < p) Xc[(size_t)i * W] = x[k];
      }
      float* Sb = blk.S + (m & 1) * TC * LD;
      wide_st<Q>(Sb + c * LD + i0, x);
      wcr_cbar();
      blk.release_tile(m);
      gr.add(Sb);
    }
  }
  __syncthreads();
  wcr_pack<PMAX>(gr, blk.S, blk.stx);
  cols_gene_store(blk.stx, NG, out, bpart + g * nb * NG, tickets + g, b.rank,
                  nb);
}

// The power step of each gene (a block of 256 threads a gene), from the S
// shards' packed partials `parts` (S slices G NG floats apart) summed in
// shard order, from u_in (null: the cold 1 / sqrt(p)).  Without K (before a
// sweep): u_out, and under ADAPT s_out, the freeze test (it > 0) and
// `done`; a gene that does not sweep (inactive, frozen) gets a zero partial
// in `gram`.  With K (the finish, and kernel 2c's cold step): u_out, s_out
// and K = u s; under ADAPT a frozen gene's u_in and s_in as they are.
template <int PMAX, bool ADAPT>
__global__ void __launch_bounds__(DN_WIDE_THREADS, 1)
    wcols_refit_kernel(const uint8_t* __restrict__ act,
                       const float* __restrict__ parts, int S,
                       const float* __restrict__ u_in,
                       float* __restrict__ u_out,
                       const float* __restrict__ s_in,
                       float* __restrict__ s_out,
                       uint8_t* done, float* __restrict__ gram,
                       float* __restrict__ K, float tol, int it, int G, int p,
                       int n_squared, int n_plain) {
  constexpr int NG = cols_ng<PMAX>(), LD = WideShape<PMAX>::LD;
  extern __shared__ float4 dyn4[];
  WideWork<PMAX> w;
  w.init((float*)dyn4);
  const size_t g = blockIdx.x;
  const int t = threadIdx.x, nt = blockDim.x;
  const bool fin = K != nullptr;
  float* out = gram != nullptr ? gram + g * NG : nullptr;
  if (act != nullptr && act[g] == 0) {
    if (t < p) {
      u_out[g * p + t] = 0.f;
      if (fin) K[g * p + t] = 0.f;
    }
    if (t == 0 && s_out != nullptr) s_out[g] = 0.f;
    if (out != nullptr)
      for (int k = t; k < NG; k += nt) out[k] = 0.f;
    return;
  }
  if constexpr (ADAPT) {
    if (done[g] != 0) {  // frozen: its state carried, nothing added
      if (t < p) {
        const float uv = u_in[g * p + t];
        u_out[g * p + t] = uv;
        if (fin) K[g * p + t] = uv * s_in[g];
      }
      if (t == 0) s_out[g] = s_in[g];
      if (out != nullptr)
        for (int k = t; k < NG; k += nt) out[k] = 0.f;
      return;
    }
  }
  if (t < PMAX)
    w.u[t] = t < p ? (u_in != nullptr ? u_in[g * p + t]
                                      : 1.0f / sqrtf((float)p))
                   : 0.f;
  // the gene's Gram with its mirror, summed in shard order
  const float* pg = parts + g * NG;
  for (int e = t; e < PMAX * PMAX; e += nt) {
    const int i = e / PMAX, j = e % PMAX;
    if (j < i) continue;
    const int k = wcols_tri<PMAX>(i, j);
    float v = pg[k];
    for (int s = 1; s < S; ++s) v = __fadd_rn(v, pg[(size_t)s * G * NG + k]);
    w.B[i * LD + j] = v;
    w.B[j * LD + i] = v;
  }
  if (ADAPT && t < PMAX) w.uo[t] = w.u[t];
  __syncthreads();
  WideGram<PMAX> gr;
  float s = 0.f;
  wide_refit<PMAX>(w, gr, n_squared, n_plain, ADAPT || fin, s);
  bool frozen = false;
  if constexpr (ADAPT) {
    if (!fin && it > 0) {  // every shard decides on the same bits
      const float s_old = s_in[g];
      float delta = 0.f, ref = 0.f;
#pragma unroll 8
      for (int j = 0; j < PMAX; ++j) {
        const float k_new = __fmul_rn(w.u[j], s);
        delta = fmaxf(delta, fabsf(k_new - __fmul_rn(w.uo[j], s_old)));
        ref = fmaxf(ref, fabsf(k_new));
      }
      ref = fmaxf(ref, DN_EPS);
      frozen = delta <= __fmul_rn(tol, ref);  // this refit kept
    }
  }
  if (t < p) {
    u_out[g * p + t] = w.u[t];
    if (fin) K[g * p + t] = w.u[t] * s;
  }
  if (t == 0 && s_out != nullptr && (ADAPT || fin)) s_out[g] = s;
  if (frozen) {
    if (t == 0) done[g] = 1;
    for (int k = t; k < NG; k += nt) out[k] = 0.f;
  }
}

// (b): one merged sweep X <- max(X - step (u v - A0), A0) of the shard's
// columns with u (and ADAPT's s) from this launch's refit, and the next
// partial Gram; an inactive or frozen gene's blocks leave at once.
template <int PMAX, bool I16, bool ADAPT>
__global__ void __launch_bounds__(DN_WCR_THREADS, wcr_blocks(PMAX))
    wcols_sweep_kernel(const void* __restrict__ F,
                       const uint8_t* __restrict__ mask,
                       const uint8_t* __restrict__ act,
                       const float* __restrict__ scale, float* X,
                       const int* __restrict__ ncols,
                       const float* __restrict__ u,
                       const float* __restrict__ s_arr,
                       const uint8_t* __restrict__ done,
                       float* __restrict__ gram, float* bpart, int* tickets,
                       int p, int W, int nmf_iter, int nb) {
  using Blk = WcrBlock<PMAX, I16>;
  constexpr int NG = cols_ng<PMAX>(), Q = WideShape<PMAX>::Q;
  constexpr int LD = Blk::LD, TC = DN_WIDE_TC, HC = DN_WCR_HC;
  extern __shared__ float4 dyn4[];
  const ColsBlock b(nb);
  const size_t g = b.g;
  const int t = threadIdx.x;
  const int nact = cols_active_blocks(ncols[g], nb);
  if (b.rank >= nact || (act != nullptr && act[g] == 0)) return;
  if constexpr (ADAPT) {
    if (done[g] != 0) return;
  }
  Blk blk((unsigned char*)dyn4);
  blk.setup(scale, u + g * p, p);
  const float s = ADAPT ? s_arr[g] : 0.f;
  const float step =
      nmf_iter > 0 ? (float)(1.0 / sqrt((double)nmf_iter)) : 0.f;
  blk.begin(F, mask, X, g, p, W, b.rank, nb,
            (ncols[g] + DN_STREAM_CHUNK - 1) / DN_STREAM_CHUNK);
  WcrMma<PMAX> gr;
  if (t >= DN_WCR_CONSUMERS) {
    blk.template produce<true>();
  } else {
    const int q = t >> 6, c = t & (TC - 1), i0 = q * Q;
    for (int m = 0; m < blk.n; ++m) {
      const int st = blk.wait_tile(m);
      const int l = blk.tl[m] * TC + c;
      const bool on = blk.msk[l] != 0;
      const float* hx = blk.stx + st * PMAX * HC + (c & 31);
      const typename Blk::A* ha = blk.sta + st * PMAX * HC + (c & 31);
      float vp = 0.f;
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        const int i = i0 + k;
        vp = fmaf((on && i < p) ? hx[i * HC] : 0.f, blk.u[i], vp);
      }
      blk.vpart[q * TC + c] = vp;
      wcr_cbar();
      // the update, four rows at a time from the stage (held until the
      // tile is released), into S; a column outside the mask stays zero
      float se = 0.f;
      if (on) {
        const float v = ((blk.vpart[c] + blk.vpart[TC + c]) +
                         blk.vpart[2 * TC + c]) +
                        blk.vpart[3 * TC + c];
        // ADAPT: est = K_i E_w taken as u_i (s E_w), as nmf_core does
        se = ADAPT ? __fmul_rn(s, v / (s + DN_EPS)) : v;
      }
      float* Xc = on ? blk.X + blk.col(l) : nullptr;
      float* Sb = blk.S + (m & 1) * TC * LD;
#pragma unroll
      for (int k4 = 0; k4 < Q; k4 += 4) {
        float x[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = i0 + k4 + j;
          x[j] = 0.f;
          if (on && i < p) {
            const float a = blk.a0(ha[i * HC], i);
            x[j] = fmaxf(hx[i * HC] - step * (blk.u[i] * se - a), a);
            Xc[(size_t)i * W] = x[j];
          }
        }
        wide_st<4>(Sb + c * LD + i0 + k4, x);
      }
      wcr_cbar();  // (also: vpart read before the next tile writes it)
      blk.release_tile(m);
      gr.add(Sb);
    }
  }
  __syncthreads();
  wcr_pack<PMAX>(gr, blk.S, blk.stx);
  cols_gene_store(blk.stx, NG, gram + g * NG, bpart + g * nb * NG,
                  tickets + g, b.rank, nact);
}

// (c): E = X^T u / (s + eps) on the shard's columns (zero outside the mask
// and past the dealt chunks), u and s from the finishing refit, as
// wide_core's finish.
template <int PMAX>
__global__ void __launch_bounds__(DN_WIDE_THREADS)
    wcols_finish_kernel(const uint8_t* __restrict__ mask,
                        const uint8_t* __restrict__ act,
                        const float* __restrict__ X,
                        const int* __restrict__ ncols,
                        const float* __restrict__ u,
                        const float* __restrict__ s_arr,
                        float* __restrict__ E, int p, int W, int nb) {
  constexpr int Q = WideShape<PMAX>::Q, TC = DN_WIDE_TC;
  constexpr int CH = DN_STREAM_CHUNK;
  __shared__ float us[PMAX];
  __shared__ float vpart[4 * TC];
  const ColsBlock b(nb);
  const size_t g = b.g;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int q = tid >> 6, c = tid & (TC - 1), i0 = q * Q;
  float* Eg = E + g * W;
  const bool live = act == nullptr || act[g] != 0;
  const int nact = live ? cols_active_blocks(ncols[g], nb) : 1;
  if (b.rank >= nact) return;
  if (!live) {
    for (int l = tid; l < W; l += nt) Eg[l] = 0.f;
    return;
  }
  if (tid < PMAX) us[tid] = tid < p ? u[g * p + tid] : 0.f;
  const float s = s_arr[g];
  __syncthreads();
  const int nch = (ncols[g] + CH - 1) / CH;
  const int nloc = (b.rank < nch ? (nch - b.rank + nb - 1) / nb : 0) * CH;
  const uint8_t* mg = mask + g * W;
  const float* Xg = X + g * p * W;
  for (int l0 = 0; l0 < nloc; l0 += TC) {
    const int l = l0 + c;
    const int w = ((l / CH) * nb + b.rank) * CH + (l % CH);
    const bool on = w < W && mg[w] != 0;
    float vp = 0.f;
    if (on) {
#pragma unroll 4
      for (int kk = 0; kk < Q; ++kk) {
        const int i = i0 + kk;
        if (i < p) vp = fmaf(Xg[(size_t)i * W + w], us[i], vp);
      }
    }
    vpart[q * TC + c] = vp;
    __syncthreads();
    if (q == 0 && w < W) {
      float e = 0.f;
      if (on) {
        const float v = ((vpart[c] + vpart[TC + c]) + vpart[2 * TC + c]) +
                        vpart[3 * TC + c];
        e = v / (s + DN_EPS);
      }
      Eg[w] = e;
    }
    __syncthreads();
  }
  // E past the dealt chunks
  for (int l = nch * CH + b.rank * nt + tid; l < W; l += nact * nt)
    Eg[l] = 0.f;
}

// Kernel 2c's second pass: u, K = u s and s from its cold refit; thread (q,
// c) takes rows q Q .. q Q + Q - 1 of its column of each listed tile of A0
// (the coverage as stored, zeros off the mask) from the ring, e = v / (s +
// eps) of the column, and adds the rows to its sums of A0 and of max(K e,
// A0); the block's 64 columns' sums are added a row in column order, and
// the blocks' meet in block order (cols_gene_store) into sums (G, 2p).
template <int PMAX, bool I16>
__global__ void __launch_bounds__(DN_WCR_THREADS, wcr_blocks(PMAX))
    wratio_cols_sums_kernel(const void* __restrict__ F,
                            const uint8_t* __restrict__ mask,
                            const int* __restrict__ ncols,
                            const float* __restrict__ u,
                            const float* __restrict__ K,
                            const float* __restrict__ s_arr,
                            float* __restrict__ sums, float* bpart,
                            int* tickets, int p, int W, int nb) {
  using Blk = WcrBlock<PMAX, I16>;
  constexpr int Q = WideShape<PMAX>::Q, LD = Blk::LD, TC = DN_WIDE_TC;
  constexpr int HC = DN_WCR_HC;
  extern __shared__ float4 dyn4[];
  const ColsBlock b(nb);
  const size_t g = b.g;
  const int t = threadIdx.x;
  const int nact = cols_active_blocks(ncols[g], nb);
  if (b.rank >= nact) return;
  Blk blk((unsigned char*)dyn4);
  blk.setup(nullptr, u + g * p, p);
  if (t < PMAX) blk.Kv[t] = t < p ? K[g * p + t] : 0.f;
  const float den = s_arr[g] + DN_EPS;
  blk.begin(F, mask, nullptr, g, p, W, b.rank, nb,
            (ncols[g] + DN_STREAM_CHUNK - 1) / DN_STREAM_CHUNK);
  const int q = (t >> 6) & 3, c = t & (TC - 1), i0 = q * Q;
  float rs[Q], es[Q];  // this thread's rows i0 .. i0 + Q - 1
#pragma unroll
  for (int k = 0; k < Q; ++k) rs[k] = es[k] = 0.f;
  if (t >= DN_WCR_CONSUMERS) {
    blk.template produce<false>();
  } else {
    for (int m = 0; m < blk.n; ++m) {
      const int st = blk.wait_tile(m);
      const bool on = blk.msk[blk.tl[m] * TC + c] != 0;
      const typename Blk::A* ha = blk.sta + st * PMAX * HC + (c & 31);
      float x[Q], vp = 0.f;
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        const int i = i0 + k;
        x[k] = (on && i < p) ? blk.raw(ha[i * HC]) : 0.f;
        vp = fmaf(x[k], blk.u[i], vp);
      }
      blk.vpart[q * TC + c] = vp;
      wcr_cbar();
      blk.release_tile(m);
      if (on) {
        const float e = (((blk.vpart[c] + blk.vpart[TC + c]) +
                          blk.vpart[2 * TC + c]) +
                         blk.vpart[3 * TC + c]) /
                        den;
#pragma unroll
        for (int k = 0; k < Q; ++k) {
          rs[k] += x[k];
          es[k] += fmaxf(blk.Kv[i0 + k] * e, x[k]);
        }
      }
      wcr_cbar();  // vpart is read before the next tile writes it
    }
  }
  __syncthreads();
  // the block's columns' sums, a row in column order
  float* S0 = blk.S;
  float* S1 = blk.S + TC * LD;
  if (t < DN_WCR_CONSUMERS) {
    wide_st<Q>(S0 + c * LD + i0, rs);
    wide_st<Q>(S1 + c * LD + i0, es);
  }
  __syncthreads();
  float* blks = blk.stx;
  if (t < p) {
    float rsum = 0.f, esum = 0.f;
    for (int k = 0; k < TC; ++k) {
      rsum += S0[k * LD + t];
      esum += S1[k * LD + t];
    }
    blks[t] = rsum;
    blks[p + t] = esum;
  }
  __syncthreads();
  cols_gene_store(blks, 2 * p, sums + g * 2 * p, bpart + g * nb * 2 * p,
                  tickets + g, b.rank, nact);
}

// ---- launches ---------------------------------------------------------------

template <int PMAX, bool ADAPT>
static int wcols_refit_launch(const ColsArgs& a, const float* u_in,
                              float* u_out, const float* s_in, float* s_out,
                              float* gram, float* K, int n_squared,
                              int n_plain) {
  const size_t dyn = sizeof(float) * wide_core_floats<PMAX>();
  const cudaError_t e = cols_prepare(wcols_refit_kernel<PMAX, ADAPT>, dyn);
  if (e != cudaSuccess) return (int)e;
  wcols_refit_kernel<PMAX, ADAPT>
      <<<(unsigned)a.G, DN_WIDE_THREADS, dyn, a.st>>>(
          a.act, a.parts, a.S, u_in, u_out, s_in, s_out, a.done, gram, K,
          a.tol, a.it, a.G, a.p, n_squared, n_plain);
  return (int)cudaGetLastError();
}

// A block's share of a gene's chunks fits DN_WCR_MAX_TILES tiles.
static inline bool wcols_geometry_ok(int W, int nb, int threads) {
  const int chunks = (W + DN_STREAM_CHUNK - 1) / DN_STREAM_CHUNK;
  return threads == DN_WCR_THREADS &&
         (chunks + nb - 1) / nb * DN_STREAM_CHUNK <=
             DN_WCR_MAX_TILES * DN_WIDE_TC;
}

template <int PM, bool I16, bool ADAPT>
static int wcols_launch(int which, const ColsArgs& a) {
  using A = typename std::conditional<I16, int16_t, float>::type;
  if (!wcols_geometry_ok(a.W, a.nb, a.threads))
    return (int)cudaErrorInvalidValue;
  constexpr int NS = wcr_stages(PM, (int)sizeof(A));
  static_assert(wcr_dyn_bytes(PM, (int)sizeof(A), NS) <= wcr_budget(PM),
                "the ring and the rest fit the block's share of the SM");
  const size_t dyn = wcr_dyn_bytes(PM, (int)sizeof(A), NS);
  const dim3 grid((unsigned)((size_t)a.G * a.nb)), block(DN_WCR_THREADS);
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
    // the gene's power step once, then the sweep on its u
    const int r = wcols_refit_launch<PM, ADAPT>(
        a, a.u_in, a.u_out, a.s_in, a.s_out, a.gram, nullptr, a.n_squared,
        a.n_plain);
    if (r != 0) return r;
    e = cols_prepare(wcols_sweep_kernel<PM, I16, ADAPT>, dyn);
    if (e != cudaSuccess) return (int)e;
    wcols_sweep_kernel<PM, I16, ADAPT><<<grid, block, dyn, a.st>>>(
        a.F, a.mask, a.act, a.scale, a.X, a.ncols, a.u_out, a.s_out, a.done,
        a.gram, a.bpart, a.tickets, a.p, a.W, a.nmf_iter, a.nb);
  } else if constexpr (I16) {
    return (int)cudaErrorInvalidValue;  // the finish reads no input: f32 TU
  } else {
    const int r = wcols_refit_launch<PM, ADAPT>(
        a, a.u_in, a.u_out, a.s_in, a.s_fin, nullptr, a.K, a.n_squared,
        a.n_plain);
    if (r != 0) return r;
    wcols_finish_kernel<PM><<<grid, DN_WIDE_THREADS, 0, a.st>>>(
        a.mask, a.act, a.X, a.ncols, a.u_out, a.s_fin, a.E, a.p, a.W, a.nb);
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
                   float* bpart, int* tickets, float* ws, int G, int p, int W,
                   int power_cold, int nb, int threads, cudaStream_t st);
