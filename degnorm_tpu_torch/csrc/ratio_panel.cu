// Kernel 2 for p > 128 samples: ratio-SVD row sums, coverage read as it is
// stored (raw int16 or float32), on panel.cuh's row panels; both input forms
// in this one translation unit.  The C entry point stays ratio.cu's
// dn_ratio_rowsums, which hands p > 128 here.
//
// Replaces, for studies of more than 128 samples, the TPU kernel
// degnorm_tpu/ops/pallas_nmf.py::ratio_rowsums_pallas (_ratio_kernel), as
// ratio_wide.cuh does for 33 <= p <= 128: A0 = F * mask, one cold rank-1
// (K, E), the row sums of A0 and of max(K (x) E, A0).  Bound on this card:
// float32 operations (the Gram's p(p+1) a column against 2p bytes of
// int16).  A value is (float)raw for int16, which is exact, and every
// operation after the load is the same for both forms in the same order, so
// int16 input gives the bits of float32 input holding the same values.  Two
// layouts, kernel 4's (dn_pcl_on(p, DN_PCL_STREAM)):
//   * the CLUSTER layout (ratio_panel_kernel): a gene's panel pairs over a
//     cluster of blocks, clusters working through the genes.  Pass 1 is
//     kernel 4's cold sweep with no X (pcl_sweep's A0_ONLY: each tile of A0
//     copied once into the blocks that need its rows by 16-byte cp.async,
//     a block's later pairs copying A0 again); the cold refit is the
//     cluster's power step (pcl_refit) with its matvecs shared by the blocks
//     at every p (a panel of rows a block, two threads a row: every block's
//     serial chains over all of B^2 left it latency-bound), so every block
//     holds the same u and s; pass 2 copies each active tile of A0 into the
//     diagonal blocks, which sum their panel's rows of it in column order,
//     publish v's partials
//     (pcl_v) and sum their panel's rows of max(K E, A0) in column order
//     (pcl_ratio_est).  B has the bits of the phased layout's Gram (the
//     block layout's panel_gram), and so do the row sums of A0; the
//     matvecs' and v's orders of summation differ;
//   * above it the PHASED layout (ratio_phase.cu, phase.cuh): the Gram of
//     A0 over (gene, panel pair) blocks of the whole card, whose diagonal
//     pairs also sum A0's rows, the cold power step on a cluster of blocks
//     a gene, then e a column and the row sums of max(K e, A0) a panel.
#include "panel.cuh"
#include "ratio.cuh"

// A gene's A0 as the cluster layout reads it (pcl_pass, pcl_stage_a): all
// W columns, read as stored, 16-byte copies where W is a multiple of 8.
template <bool I16>
struct RatioPclSrc {
  using AType = typename std::conditional<I16, int16_t, float>::type;
  const AType* F;  // the gene's (p, W) rows
  const uint8_t* __restrict__ mask;
  int W;
  __device__ __forceinline__ int n_local() const { return W; }
  __device__ __forceinline__ bool on(int l) const {
    return l < W && mask[l] != 0;
  }
  __device__ __forceinline__ float a0v(AType a, int) const {
    return ratio_val(a);
  }
  __device__ __forceinline__ bool vec() const { return W % 8 == 0; }
  // (l0 is an active tile's, below W)
  __device__ __forceinline__ int valid_cols(int l0) const {
    return W - l0 < DN_WIDE_TC ? W - l0 : DN_WIDE_TC;
  }
  __device__ __forceinline__ const AType* arow(int i, int l0) const {
    return F + (size_t)i * W + l0;
  }
};

// Pass 2 of the cluster layout, after a cluster barrier (the power step's
// reads of the blocks' B are done, whose places the tile and copy slot
// take): for each tile with an active column, the diagonal blocks copy their
// panel's rows of A0 into tile 0 (zero off the mask and past p) and thread t
// < 128 adds row I * 128 + t of it in column order, every block takes v of
// the tile's columns (pcl_v: the diagonal blocks' partials), and each
// diagonal block puts max(K_i e_l, A0) with e = v / (s + eps) in place (zero
// off the mask) and adds its rows of that the same way, as the block layout
// stages and adds both.  K in w.uo().  Each diagonal block writes its panel
// of `cov` and `est`.  Compiled out of line (beside the sweep's register
// tile the kernel's registers would spill), so its arguments are values;
// returns w.nact, advanced.
template <class Src, class A>
static __device__ __noinline__ int pcl_ratio_est(Src src, PclWork<A> w,
                                                 float s, float* cov,
                                                 float* est) {
  constexpr int TC = DN_WIDE_TC, LD = DN_PANEL_LD, R = DN_PANEL_ROWS;
  const int t = threadIdx.x, q = t >> 6, c = t & (TC - 1), p = w.p;
  const int ntile = (src.n_local() + TC - 1) / TC;
  const float den = s + DN_EPS;
  float* St = w.tile(0);
  float* Sc = St + c * LD + q * 32;
  const A* sa = w.slot(0);
  const int i0 = w.I * R + q * 32;
  float cs = 0.f, es = 0.f;
  cg::this_cluster().sync();
  for (int k = pcl_next(src, 0, ntile); k < ntile;
       k = pcl_next(src, k + 1, ntile)) {
    const bool on = src.on(k * TC + c);
    if (w.diag()) {
      pcl_stage_a(src, w, k * TC, 0);
      dn_cp_async_commit();
      dn_cp_async_wait_all();
      __syncthreads();  // the copy is in
#pragma unroll 2
      for (int j4 = 0; j4 < 32; j4 += 4) {
        float x4[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = j4 + jj;
          x4[jj] = (on && i0 + j < p)
                       ? src.a0v(sa[(q * 32 + j) * TC + c], i0 + j)
                       : 0.f;
        }
        wide_st<4>(Sc + j4, x4);
      }
      __syncthreads();  // the tile is in place
      if (t < R)
        for (int kk = 0; kk < TC; ++kk) cs += St[kk * LD + t];
    }
    const float v = pcl_v(w, on, St + c * LD);
    if (w.diag()) {
      const float e = v / den;
#pragma unroll 2
      for (int j4 = 0; j4 < 32; j4 += 4) {
        float x4[4];
        wide_ld<4>(Sc + j4, x4);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = j4 + jj;
          x4[jj] = (on && i0 + j < p) ? fmaxf(w.uo()[i0 + j] * e, x4[jj])
                                      : 0.f;
        }
        wide_st<4>(Sc + j4, x4);
      }
      __syncthreads();
      if (t < R)
        for (int kk = 0; kk < TC; ++kk) es += St[kk * LD + t];
      __syncthreads();  // S and the copy slot are read before the next tile
    }
  }
  if (w.diag() && t < R && w.I * R + t < p) {
    cov[w.I * R + t] = cs;
    est[w.I * R + t] = es;
  }
  return w.nact;
}

// Pass 1 of the cluster layout: the cold sweep's Gram of A0 into B (pcl_sweep's
// A0_ONLY), returning B's largest |entry|.  Compiled out of line with its own
// register tile (inline, the kernel's registers spilled around the power
// step's calls), so its arguments are values.
template <class Src, class A>
static __device__ __noinline__ float pcl_ratio_gram(Src src, PclWork<A> w) {
  WideGram<128> g;
  return pcl_sweep<false, false, true>(src, w, g, 0.f, 0.f, false);
}

// The cold refit on the cluster's B (pcl_refit: the squared scheme's
// power_cold iterations, then s), returning s; u comes back refit in w.u().
// Out of line, as pcl_ratio_gram.  (w.npow advances in this copy alone: the
// next refit's first matvec comes after cluster barriers that every block
// passes once it has copied this one's last.)
template <class A>
static __device__ __noinline__ float pcl_ratio_refit(PclWork<A> w, float bmax,
                                                     int power_cold) {
  float s;
  pcl_refit<true, true>(w, bmax, power_cold, 0, true, s);
  return s;
}

template <bool I16>
__global__ void __launch_bounds__(DN_WIDE_THREADS, 1)
    ratio_panel_kernel(const void* __restrict__ Fv,
                     const uint8_t* __restrict__ mask,
                     float* __restrict__ cov_sums,
                     float* __restrict__ est_sums, int G, int p, int W,
                     int power_cold, float* ws) {
  using Src = RatioPclSrc<I16>;
  using A = typename Src::AType;
  extern __shared__ float4 dyn4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x;
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  PclWork<A> w;
  // (the cluster's slot of the workspace where a block holds several pairs;
  // the blocks share the power step at every p)
  w.init((float*)dyn4, p, rank,
         ws != nullptr ? ws + (blockIdx.x / C) * dn_pcl_ws_floats(p) : nullptr,
         true);
  w.X = nullptr;  // (no X: the Gram of A0)
  for (size_t gi = blockIdx.x / C; gi < (size_t)G; gi += gridDim.x / C) {
    Src src;
    src.F = (const A*)Fv + gi * p * W;
    src.mask = mask + gi * W;
    src.W = W;
    for (int i = t; i < w.np; i += DN_WIDE_THREADS)
      w.u()[i] = i < p ? 1.0f / sqrtf((float)p) : 0.f;
    __syncthreads();
    // pass 1: the Gram of A0
    const float bmax = pcl_ratio_gram(src, w);
    const float s = pcl_ratio_refit(w, bmax, power_cold);
    for (int i = t; i < w.np; i += DN_WIDE_THREADS)
      w.uo()[i] = w.u()[i] * s;  // K
    __syncthreads();
    // pass 2: the row sums of A0 and of max(K E, A0) over the active columns
    w.nact = pcl_ratio_est(src, w, s, cov_sums + gi * p, est_sums + gi * p);
    // no block's shared memory is read any more (the next gene's sweep, or
    // the end)
    cluster.sync();
  }
}

int dn_ratio_panel(const RatioArgs& a, int f_is_i16) {
  if (a.threads != DN_WIDE_THREADS || a.cl != 1 || a.p < DN_PANEL_MIN_P)
    return (int)cudaErrorInvalidValue;
  if (dn_pcl_on(a.p, DN_PCL_STREAM)) {
    // blocks of several pairs keep them in the workspace
    if (dn_pcl_held(a.p) > 1 && a.ws == nullptr)
      return (int)cudaErrorInvalidValue;
#define DN_RATIO_PCL_ARGS                                                     \
  DN_PCL_STREAM, a.G, a.p, a.ws_slots, (size_t)dn_pcl_smem_floats(a.p), a.st, \
      a.F, a.mask, a.cov, a.est, a.G, a.p, a.W, a.power_cold,                 \
      dn_pcl_held(a.p) > 1 ? a.ws : nullptr
    if (f_is_i16)
      return launch_pcl(ratio_panel_kernel<true>, DN_RATIO_PCL_ARGS);
    return launch_pcl(ratio_panel_kernel<false>, DN_RATIO_PCL_ARGS);
#undef DN_RATIO_PCL_ARGS
  }
  return dn_ratio_phase(a, f_is_i16);
}

// The clusters the card holds at once of kernel 2 at p on the cluster layout
// (its int16 instance where f_is_i16, else its float32 one), or a negative
// CUDA error: what launch_pcl launches at most.
extern "C" int dn_ratio_panel_clusters(int p, int f_is_i16) {
  if (!dn_pcl_on(p, DN_PCL_STREAM)) return -(int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int fit = 0;
  const size_t smem = (size_t)dn_pcl_smem_floats(p);
  const int e = f_is_i16 ? pcl_occupancy(ratio_panel_kernel<true>, p, smem, cfg,
                                         attr, fit)
                         : pcl_occupancy(ratio_panel_kernel<false>, p, smem,
                                         cfg, attr, fit);
  return e != 0 ? -e : fit;
}
