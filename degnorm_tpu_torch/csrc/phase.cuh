// Shared device code of kernels 4 and 2 past DN_PCL_MAX_P_STREAM samples and
// of kernels 1 and 3 past DN_PCL_MAX_P (sm_90a, plain float32): THE PHASED
// LAYOUT.  A gene's panel pairs spread over the whole card in a short,
// fixed sequence of launches on the caller's stream, in place of one block
// a gene (the block layout, which this replaced; kernel 3 runs each trim
// round's loop here: trim_panel.cu).
//
// Replaces, past each kernel's cluster layout, its block layout (and so the
// same TPU code: degnorm_tpu/ops/pallas_stream.py::nmf_masked_streamed,
// degnorm_tpu/ops/pallas_nmf.py::nmf_masked_pallas with its nmf_tol loop
// _nmf_loop, and ratio_rowsums_pallas, whose _gram, _power and _nmf_loop
// run here in phases).  The cluster layout (panel.cuh, pcl_*) stops at T = 9
// panels: a block's shared memory holds the p-vectors beside the tiles only
// up to p = 1,152, a cluster of T blocks past it fits only a few times on
// the card, and no cluster holds more than 16 (kernels 1 and 3 stop at T =
// 5, where their blocks' own power step still fits).  The block layout ran
// one gene on one SM and read X T(T+1)/2 + 2 times a sweep.  Here there is
// no cap on p but the power step's shared memory (dn_phase_power_floats: p
// near 19,000, where a gene's B and B^2 alone take 2.9 GB).
//
// The genes of a call (kernels 4 and 1: their active ones, a list built on
// the card by phase_prep_kernel) go in groups of at most `slots` (one an
// SM: the block layout's budget), each gene of a group with its slot of the
// workspace: B and B^2 (p x dn_phase_ldb(p) floats each), u and its
// scalars (s, B's largest entry, the nmf_tol branch's frozen flag and
// iterations).  Each group runs these phases, each one launch over the
// group's genes (blocks past the group's active genes, or of a frozen gene,
// return at once):
//   1. columns (phase_cols_kernel, a block a tile of 64 columns of a gene):
//      the loop's cold X = A0, each iteration's v = X^T u and multiplier
//      update, the finish's E = X^T u / (s + eps), K and u; kernel 2's e =
//      A0^T u / (s + eps) of its second pass, into the slot;
//   2. the Gram (phase_gram_kernel, a block a (gene, panel pair)): the 8 x
//      8 register tile of WideGram<128> (syrk2) over the gene's active tiles
//      in column order, a tile's rows loaded into registers while the last
//      tile's products run, then stored transposed into one of two tiles in
//      shared memory; B with its mirror into the slot, its largest |entry|
//      by an integer atomicMax on the float's bits (exact and independent
//      of order: every entry is >= 0); kernel 2's diagonal pairs also sum
//      A0's rows.  B^2 of the squared scheme is the same launch over B's
//      rows scaled by 1 / (max + eps);
//   3. the power step (phase_power_kernel, a cluster of DN_PHASE_C blocks a
//      gene): each matvec a thread a row of the block's share of the rows,
//      in column order j = 0 .. p - 1, the rows published in the block's
//      shared memory, one cluster barrier, every block copying the whole
//      vector; each norm by every block in the order of panel_sum.  Under
//      nmf_tol (kernel 1's branch: tol > 0) every refit also computes s, and
//      a gene whose max|dK| <= tol max|K| is frozen after it, that sweep's
//      update kept: the later launches of its group skip it, and the finish
//      writes the iterations it ran;
//   4. kernel 2 only: its row sums of max(K e, A0) (phase_est_kernel, a
//      block a (gene, panel)), thread t < 128 its row in column order.
// Every sum is the block layout's, in its order (its Gram passes, v, the
// matvecs, panel_renormalize, panel_sum, panel_max, the row sums), so the
// outputs are bit-equal to it.
//
// What bounds it on this card: the Gram's float32 operations (T(T+1)/2 x
// 128^2 fmas a column a sweep, over every SM); the update's bytes (X read
// twice and written, A0 read); the power step's reads of B^2 (p^2 floats a
// matvec a gene: device memory where the group's B^2 do not fit the 50 MB
// L2).  Kept from common.cuh: no float atomics, no -use_fast_math.
#pragma once

#include "panel.cuh"

#define DN_PHASE_C 8          // blocks of a gene's power step (portable)
#define DN_PHASE_LIST 2048    // active tiles a Gram block lists at a time
#define DN_PHASE_SCAL 4       // a slot's scalars: s, B's largest entry,
                              // frozen (nmf_tol), iterations run
// what a Gram launch reads: kernel 4's X, kernel 2's A0 (with its row
// sums), or B (into B^2, scaled)
#define DN_PH_X 0
#define DN_PH_A0 1
#define DN_PH_B 2
// what a column launch does: kernel 4's cold X = A0, update and finish,
// kernel 2's e
#define DN_PHC_XINIT 0
#define DN_PHC_UPDATE 1
#define DN_PHC_FINISH 2
#define DN_PHC_RATIO 3

// The phased layout takes a kernel past its cluster layout, a rule by kind
// (panel.cuh's DN_PCL_*): kernels 1 and 3 (DN_PCL_LOOP) past DN_PCL_MAX_P,
// kernels 2 and 4 (DN_PCL_STREAM) past DN_PCL_MAX_P_STREAM.
__host__ __device__ inline bool dn_phase_on(int p, int kind) {
  return p > dn_pcl_max_p(kind);
}
// Floats a row of B and B^2 takes (16-byte aligned rows).
__host__ __device__ inline int dn_phase_ldb(int p) { return (p + 3) / 4 * 4; }
// Floats of a gene's slot: B, B^2, u (np) and the scalars.
__host__ __device__ inline size_t dn_phase_slot_floats(int p) {
  return 2 * (size_t)p * dn_phase_ldb(p) + dn_panel_np(p) + DN_PHASE_SCAL;
}
// Floats of a call's workspace: `slots` slots, kernel 4's scales and their
// reciprocals (np each), the list of active genes (its count, then G).
__host__ __device__ inline size_t dn_phase_ws_floats(int p, int slots, int G) {
  return (size_t)slots * dn_phase_slot_floats(p) + 2 * (size_t)dn_panel_np(p) +
         G + 1;
}
// Rows of a matvec a block of the power step computes.
__host__ __device__ inline int dn_phase_rows(int p) {
  return (p + DN_PHASE_C - 1) / DN_PHASE_C;
}
// Floats of the power step's shared memory: u and two matvec results (np
// each), the published rows (two by parity), 32 of scratch.
__host__ __device__ inline int dn_phase_power_floats(int p) {
  return 3 * dn_panel_np(p) + 2 * dn_phase_rows(p) + 32;
}
// Floats of the Gram's shared memory: two tiles of two panels (TC x LD
// each), the tile list and 16 counters.
__host__ __device__ constexpr int dn_phase_gram_floats() {
  return 4 * DN_WIDE_TC * DN_PANEL_LD + DN_PHASE_LIST + 16;
}

// What every launch of a call reads (passed by value).
struct PhaseArgs {
  const void* F;          // coverage (G, p, W): int16 or float32
  const uint8_t* mask;    // (G, W)
  float* X;               // kernel 4's scratch (G, p, W)
  float* ws;              // the slots
  float* ss;              // kernel 4's scales (np; null for kernel 2) ...
  float* rs;              // ... and their reciprocals
  int* list;              // the count of active genes, then their indices
  const float* u0;        // kernels 4 and 1: the warm start (G, p), or null
  float* K;               // kernels 4 and 1: outputs (G, p), (G, W), (G, p)
  float* E;
  float* u;
  float* cov;             // kernel 2's outputs (G, p)
  float* est;
  int* iters;             // kernel 1: the iterations each gene ran, or null
  int G, p, W, base;      // base: the group's first entry of the list
  int nmf_iter;
  float tol;              // kernel 1's nmf_tol branch where > 0
  int iter;               // the sweep of a warm power step (its freeze)
  // kernel 3's rounds (trim_panel.cu): `keep` leaves the outputs of the
  // genes off the list as they are (kernels 4 and 1 zero them); `from_x`
  // starts the loop from the X each gene holds (trim_fast's later rounds);
  // `listed`, where > 0, the most genes the list can hold (known on the
  // host: the groups stop there), else G
  int keep, from_x, listed;
};

// A gene's slot of the workspace.
struct PhaseSlot {
  float* B;      // p x ldb; kernel 2's e (W floats) after its power step
  float* B2;     // p x ldb
  float* u;      // np
  float* scal;   // s, B's largest |entry|, frozen, iterations (int bits)
  __device__ __forceinline__ PhaseSlot(float* ws, int slot, int p) {
    B = ws + (size_t)slot * dn_phase_slot_floats(p);
    B2 = B + (size_t)p * dn_phase_ldb(p);
    u = B2 + (size_t)p * dn_phase_ldb(p);
    scal = u + dn_panel_np(p);
  }
  __device__ __forceinline__ int* bmax() const { return (int*)scal + 1; }
  __device__ __forceinline__ int* frozen() const { return (int*)scal + 2; }
  __device__ __forceinline__ int* ran() const { return (int*)scal + 3; }
};

// The group's gene of this block's slot, or -1 past its active genes and,
// under nmf_tol, for a frozen gene unless `frozen_too` (block-uniform).
__device__ __forceinline__ int phase_gene(const PhaseArgs& a, int slot,
                                          bool frozen_too = false) {
  const int gi = a.base + slot;
  const int g = gi < a.list[0] ? a.list[1 + gi] : -1;
  if (g >= 0 && a.tol > 0.f && !frozen_too &&
      *PhaseSlot(a.ws, slot, a.p).frozen() != 0)
    return -1;
  return g;
}

// Tile k (columns 64 k ..) of a gene has an active column below n.
__device__ __forceinline__ bool phase_tile_on(const uint8_t* mg, int n, int k) {
  const int l0 = k * DN_WIDE_TC, l1 = n - l0 < DN_WIDE_TC ? n : l0 + DN_WIDE_TC;
  if (l1 - l0 == DN_WIDE_TC && ((uintptr_t)(mg + l0) & 15) == 0) {
    const uint4* m4 = (const uint4*)(mg + l0);
    uint32_t o = 0;
#pragma unroll
    for (int j = 0; j < DN_WIDE_TC / 16; ++j) {
      const uint4 v = m4[j];
      o |= v.x | v.y | v.z | v.w;
    }
    return o != 0;
  }
  for (int l = l0; l < l1; ++l)
    if (mg[l] != 0) return true;
  return false;
}

// The tiles k0 <= k < k1 with an active column, in order, into tl; returns
// their count (block-uniform).  cnt: 9 ints of shared memory.
__device__ __forceinline__ int phase_list_tiles(const uint8_t* mg, int n,
                                                int k0, int k1, int* tl,
                                                int* cnt) {
  const int t = threadIdx.x, lane = t & 31, wp = t >> 5;
  constexpr int NW = DN_WIDE_THREADS / 32;
  if (t == 0) cnt[NW] = 0;
  __syncthreads();
  for (int b = k0; b < k1; b += DN_WIDE_THREADS) {
    const int k = b + t;
    const bool on = k < k1 && phase_tile_on(mg, n, k);
    const unsigned bal = __ballot_sync(DN_FULL, on);
    if (lane == 0) cnt[wp] = __popc(bal);
    __syncthreads();
    int off = cnt[NW];
    for (int j = 0; j < wp; ++j) off += cnt[j];
    if (on) tl[off + __popc(bal & ((1u << lane) - 1u))] = k;
    __syncthreads();
    if (t == 0)
      for (int j = 0; j < NW; ++j) cnt[NW] += cnt[j];
    __syncthreads();
  }
  return cnt[NW];
}

// WideGram<128>::syrk2 over a tile of DN_WIDE_TC columns with four
// columns' loads in flight (two in syrk2: at one block an SM, eight warps,
// the fmas waited on them): the same products in the same order.
__device__ __forceinline__ void phase_syrk2(WideGram<128>& g, const float* MI,
                                            const float* MJ) {
  constexpr int LD = DN_PANEL_LD;
#pragma unroll 4
  for (int k = 0; k < DN_WIDE_TC; ++k) {
    float a[8], b[8];
    wide_ld<8>(MI + k * LD + g.ty * 8, a);
    wide_ld<8>(MJ + k * LD + g.tx * 8, b);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int s = 0; s < 8; ++s) g.acc[r][s] = fmaf(a[r], b[s], g.acc[r][s]);
  }
}

// The Gram of one (gene, panel pair) of the group: block (e, slot), pair e
// of T panels (dn_pcl_pair).  KIND: DN_PH_X (kernel 4's X scratch, masked),
// DN_PH_A0 (kernel 2's coverage as stored, masked; I16: int16; its
// diagonal pairs also sum A0's rows into cov) or DN_PH_B (the slot's B
// scaled by 1 / (its largest entry + eps), every "column" k < p, into
// B^2).  Each entry is panel_gram's fma chain over the active tiles in
// column order (tiles with none add exact zeros there and are skipped
// here); B and B^2 are stored with their mirror, B's largest |entry| into
// the slot.
template <int KIND, bool I16>
__global__ void __launch_bounds__(DN_WIDE_THREADS, 1)
    phase_gram_kernel(PhaseArgs a) {
  using Raw = typename std::conditional<KIND == DN_PH_A0 && I16, int16_t,
                                        float>::type;
  constexpr int TC = DN_WIDE_TC, LD = DN_PANEL_LD, R = DN_PANEL_ROWS;
  constexpr int TILE = TC * LD;  // floats of one panel of a tile
  extern __shared__ float4 dyn4[];
  float* S = (float*)dyn4;  // [buffer][panel I, J]: TILE each
  int* tl = (int*)(S + 4 * TILE);
  int* cnt = tl + DN_PHASE_LIST;
  const int t = threadIdx.x, q = t >> 6, c = t & (TC - 1);
  const int g = phase_gene(a, blockIdx.y);
  if (g < 0) return;
  const int p = a.p, ldb = dn_phase_ldb(p);
  int I, J;
  dn_pcl_pair(dn_pcl_T(p), blockIdx.x, I, J);
  const bool diag = I == J;
  const PhaseSlot sl(a.ws, blockIdx.y, p);
  const Raw* F;
  const uint8_t* mg = nullptr;
  int ld, n;
  float inv = 1.f;
  float* M;
  if constexpr (KIND == DN_PH_B) {
    F = sl.B;
    ld = ldb;
    n = p;
    inv = 1.0f / (__int_as_float(*sl.bmax()) + DN_EPS);
    M = sl.B2;
  } else {
    F = (KIND == DN_PH_X ? (const Raw*)a.X : (const Raw*)a.F) +
        (size_t)g * p * a.W;
    mg = a.mask + (size_t)g * a.W;
    ld = n = a.W;
    M = sl.B;
  }
  // this thread's 32 rows of panels I and J of its column of the next tile
  Raw ra[32], rb[32];
  bool on_n = false;
  const int iI = I * R + q * 32, iJ = J * R + q * 32;
  const auto load = [&](int k) {
    const int l = k * TC + c;
    const bool lv = l < n;
    on_n = lv && (mg == nullptr || mg[l] != 0);
#pragma unroll
    for (int j = 0; j < 32; ++j)
      ra[j] = (lv && iI + j < p) ? F[(size_t)(iI + j) * ld + l] : Raw(0);
    if (!diag) {
#pragma unroll
      for (int j = 0; j < 32; ++j)
        rb[j] = (lv && iJ + j < p) ? F[(size_t)(iJ + j) * ld + l] : Raw(0);
    }
  };
  // ... as panel_stage stages them (zeros off the mask and past p)
  const auto val = [&](Raw r) -> float {
    if constexpr (KIND == DN_PH_B) return r * inv;
    else return ratio_val(r);
  };
  const auto store = [&](int b) {
    float* St = S + b * 2 * TILE + c * LD + q * 32;
#pragma unroll
    for (int k4 = 0; k4 < 32; k4 += 4) {
      float x[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) x[jj] = on_n ? val(ra[k4 + jj]) : 0.f;
      wide_st<4>(St + k4, x);
    }
    if (!diag) {
#pragma unroll
      for (int k4 = 0; k4 < 32; k4 += 4) {
        float x[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) x[jj] = on_n ? val(rb[k4 + jj]) : 0.f;
        wide_st<4>(St + TILE + k4, x);
      }
    }
  };

  WideGram<128> gr;
  gr.zero();
  float rs = 0.f;
  const int ntile = (n + TC - 1) / TC;
  for (int k0 = 0; k0 < ntile; k0 += DN_PHASE_LIST) {
    const int k1 = ntile - k0 < DN_PHASE_LIST ? ntile : k0 + DN_PHASE_LIST;
    const int nl =
        mg == nullptr ? k1 - k0 : phase_list_tiles(mg, n, k0, k1, tl, cnt);
    const auto tile = [&](int m) { return mg == nullptr ? k0 + m : tl[m]; };
    if (nl == 0) continue;
    load(tile(0));
    store(0);
    __syncthreads();
    for (int m = 0; m < nl; ++m) {
      const int b = m & 1;
      const bool more = m + 1 < nl;
      if (more) load(tile(m + 1));  // in flight through this tile's products
      const float* SI = S + b * 2 * TILE;
      if (KIND == DN_PH_A0 && diag && t < R)
        for (int k = 0; k < TC; ++k) rs += SI[k * LD + t];
      phase_syrk2(gr, SI, diag ? SI : SI + TILE);
      if (more) store(b ^ 1);  // the other tile was read before the barrier
      __syncthreads();
    }
  }

  float mx = 0.f;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = I * R + gr.ty * 8 + r;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int col = J * R + gr.tx * 8 + s;
      if (row < p && col < p) {
        M[(size_t)row * ldb + col] = gr.acc[r][s];
        if (!diag) M[(size_t)col * ldb + row] = gr.acc[r][s];
        mx = fmaxf(mx, fabsf(gr.acc[r][s]));
      }
    }
  }
  if constexpr (KIND != DN_PH_B) {
    mx = warp_max(mx);
    if ((t & 31) == 0 && mx > 0.f) atomicMax(sl.bmax(), __float_as_int(mx));
  }
  if (KIND == DN_PH_A0 && diag && t < R && I * R + t < p)
    a.cov[(size_t)g * p + I * R + t] = rs;
}

// A column launch: block (k, slot), thread (q, c) column l = 64 k + c of
// the slot's gene, its rows q * 32 + j of every panel (panel_v's order).
// KIND (DN_PHC_*): the loop's cold X = A0 (on the mask, unless a.from_x
// keeps the X held; the gene's first block also clears its frozen flag and
// sets its iterations to nmf_iter),
// an iteration's v and multiplier update (under nmf_tol on the (K, E)
// carry: s (v / (s + eps)) in place of v), the finish's E (every column:
// zero off the mask) with K, u and the iterations by the gene's first
// block; kernel 2's e = v / (s + eps) into the slot (B's place) on the
// mask.  I16: the coverage is raw int16 (kernel 4: over its scale,
// common.cuh's scaled_i16; kernel 2: its value).
template <int KIND, bool I16>
__global__ void __launch_bounds__(DN_WIDE_THREADS)
    phase_cols_kernel(PhaseArgs a) {
  using AT = typename std::conditional<I16, int16_t, float>::type;
  constexpr int TC = DN_WIDE_TC, R = DN_PANEL_ROWS;
  __shared__ float vpart[4 * TC];
  const int t = threadIdx.x, q = t >> 6, c = t & (TC - 1);
  const int g = phase_gene(a, blockIdx.y,
                           KIND == DN_PHC_FINISH || KIND == DN_PHC_XINIT);
  if (g < 0) return;
  const int p = a.p, W = a.W, T = dn_pcl_T(p);
  const int l = blockIdx.x * TC + c;
  const bool on = l < W && a.mask[(size_t)g * W + l] != 0;
  const AT* Fg = (const AT*)a.F + (size_t)g * p * W + l;
  float* Xg = a.X + (size_t)g * p * W + l;
  const auto a0 = [&](int i) -> float {
    if constexpr (KIND == DN_PHC_RATIO) return ratio_val(Fg[(size_t)i * W]);
    else if constexpr (I16)
      return scaled_i16(Fg[(size_t)i * W], a.ss[i], a.rs[i]);
    else return Fg[(size_t)i * W];
  };
  const PhaseSlot sl(a.ws, blockIdx.y, p);
  if constexpr (KIND == DN_PHC_XINIT) {
    if (on && !a.from_x)
      for (int i = q; i < p; i += 4) Xg[(size_t)i * W] = a0(i);
    if (blockIdx.x == 0 && t == 0) {
      *sl.frozen() = 0;
      *sl.ran() = a.nmf_iter;
    }
    return;
  }
  const float* u = sl.u;
  // v = sum_i x_i u_i: this thread's rows, then the four quarters in order
  float vp = 0.f;
  if (on) {
    for (int P = 0; P < T; ++P) {
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {
        const int i = P * R + q * 32 + j;
        if (i < p)
          vp = fmaf(KIND == DN_PHC_RATIO ? a0(i) : Xg[(size_t)i * W], u[i],
                    vp);
      }
    }
  }
  vpart[q * TC + c] = vp;
  const bool any = __syncthreads_or(on);
  const float v = any ? ((vpart[c] + vpart[TC + c]) + vpart[2 * TC + c]) +
                            vpart[3 * TC + c]
                      : 0.f;
  if constexpr (KIND == DN_PHC_UPDATE) {
    if (!on) return;  // a column outside the mask stays exactly zero
    const float step =
        a.nmf_iter > 0 ? (float)(1.0 / sqrt((double)a.nmf_iter)) : 0.f;
    const float s = sl.scal[0];
    const float se = a.tol > 0.f ? __fmul_rn(s, v / (s + DN_EPS)) : v;
    for (int P = 0; P < T; ++P) {
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {
        const int i = P * R + q * 32 + j;
        if (i < p) {
          const float av = a0(i);
          const float x = Xg[(size_t)i * W];
          Xg[(size_t)i * W] = fmaxf(x - step * (u[i] * se - av), av);
        }
      }
    }
  } else if constexpr (KIND == DN_PHC_FINISH) {
    const float s = sl.scal[0];
    if (q == 0 && l < W)
      a.E[(size_t)g * W + l] = on ? v / (s + DN_EPS) : 0.f;
    if (blockIdx.x == 0) {
      for (int i = t; i < p; i += DN_WIDE_THREADS) {
        a.K[(size_t)g * p + i] = u[i] * s;
        a.u[(size_t)g * p + i] = u[i];
      }
      if (t == 0 && a.iters != nullptr) a.iters[g] = *sl.ran();
    }
  } else {
    const float den = sl.scal[0] + DN_EPS;
    if (q == 0 && on) sl.B[l] = v / den;
  }
}

// A launch over the group: grid (x, slots), or clusters of DN_PHASE_C
// blocks a slot (`cluster`), `dyn` bytes of dynamic shared memory.  Returns
// the CUDA error, 0 on success.
template <class Kern, class... Args>
int phase_launch(Kern kern, unsigned x, int slots, size_t dyn, bool cluster,
                 cudaStream_t st, Args... args) {
  if (dyn > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = cluster ? dim3((unsigned)(slots * DN_PHASE_C), 1, 1)
                        : dim3(x, (unsigned)slots, 1);
  cfg.blockDim = dim3(DN_WIDE_THREADS, 1, 1);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = st;
  if (cluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = DN_PHASE_C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The workspace's parts of a call at `slots` slots: the scales (kernel 4),
// their reciprocals and the list.
inline void phase_parts(PhaseArgs& pa, float* ws, int slots, bool scales) {
  const size_t np = dn_panel_np(pa.p);
  pa.ws = ws;
  float* tail = ws + (size_t)slots * dn_phase_slot_floats(pa.p);
  pa.ss = scales ? tail : nullptr;
  pa.rs = scales ? tail + np : nullptr;
  pa.list = (int*)(tail + 2 * np);
}

// The shared memory of a launch of the power step at p fits a block.
inline bool phase_fits(int p) {
  return sizeof(float) * (size_t)dn_phase_power_floats(p) <= 232448;
}

// Defined in stream_phase.cu, which holds the kernels that kernels 4, 1 and
// 2 launch: the list of active genes (phase_prep_kernel), the power step of
// a group (where `square`, B^2 first: phase_gram_kernel<DN_PH_B>, then
// phase_power_kernel), and the whole Lagrangian loop of kernels 4 and 1
// (phase_loop: `a` with its workspace parts set, raw int16 + scale input
// where `i16`, float32 otherwise; a.tol > 0 the nmf_tol branch).
int phase_prep(const PhaseArgs& pa, const uint8_t* act, const float* scale,
               int slots, cudaStream_t st);
int phase_power(const PhaseArgs& pa, int slots, int n_squared, int n_plain,
                int finish, int cold, bool square, cudaStream_t st);
int phase_loop(const PhaseArgs& a, bool i16, const uint8_t* act,
               const float* scale, int slots, int power_cold, int power_warm,
               int warm_plain, cudaStream_t st);
