// Kernel 4 for p > 128 samples: the Lagrangian NMF-OA loop for wide genes,
// coverage read as it is stored (raw int16 + scale, or float32), on
// panel.cuh's row panels; both input forms in this one translation unit.
// The C entry point stays stream.cu's dn_nmf_streamed, which hands p > 128
// here.
//
// Replaces, for studies of more than 128 samples, the TPU kernel
// degnorm_tpu/ops/pallas_stream.py::nmf_masked_streamed (_stream_kernel), as
// stream_wide.cuh does for 33 <= p <= 128, with the same arguments, input
// forms and results: int16 + scale takes common.cuh's scaled_i16, the IEEE
// quotient, so that it gives the float32 form's bits.  Bound on this card:
// float32 operations (panel.cuh).  Two layouts:
//   * p <= DN_PCL_MAX_P_STREAM (nmf_stream_panel_kernel): a CLUSTER of
//     blocks a gene, its panel pairs over the blocks (panel.cuh's pcl_core;
//     past 640 samples T blocks, which share the power step), clusters
//     working through the genes; each tile of X and A0 is copied once a
//     sweep into the blocks that need its rows, B lives in the cluster's
//     shared memory where a block holds one pair, else in its slot of the
//     workspace; X in the global scratch, column by column; the gene's
//     columns are swept up to its last active one;
//   * above: the PHASED layout (stream_phase.cu, phase.cuh), the gene's
//     panel pairs spread over the whole card in a fixed sequence of
//     launches.
#include "panel.cuh"
#include "stream_wide.cuh"

template <bool I16>
__global__ void __launch_bounds__(DN_WIDE_THREADS, 1)
    nmf_stream_panel_kernel(const void* __restrict__ F,
                            const uint8_t* __restrict__ mask,
                            const uint8_t* __restrict__ act,
                            const float* __restrict__ scale,
                            const float* __restrict__ u0, float* Xscratch,
                            float* __restrict__ K, float* __restrict__ E,
                            float* __restrict__ u_out, int G, int p, int W,
                            int nmf_iter, int power_cold, int power_warm,
                            int warm_plain, float* ws) {
  using Src = WideStreamSrc<DN_PANEL_ROWS, I16>;
  constexpr int CH = DN_STREAM_CHUNK;
  __shared__ int s_ncols;  // last active column of the gene + 1
  extern __shared__ float4 dyn4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  PclWork<typename Src::AType> w;
  // (the cluster's slot of the workspace where a block holds several pairs)
  w.init((float*)dyn4, p, rank,
         ws != nullptr ? ws + (blockIdx.x / C) * dn_pcl_ws_floats(p)
                       : nullptr);
  float* ss = w.x(0);  // the scales (ones for float32 input) ...
  float* rs = w.x(1);  // ... and their reciprocals
  for (int i = tid; i < w.np; i += nt) {
    const float sv = (I16 && i < p) ? scale[i] : 1.0f;
    ss[i] = sv;
    rs[i] = 1.0f / sv;
  }
  for (size_t g = blockIdx.x / C; g < (size_t)G; g += gridDim.x / C) {
    const uint8_t* mg = mask + g * W;
    float* Eg = E + g * W;
    // act[g] is the same for the whole cluster: every block skips the gene
    if (act != nullptr && act[g] == 0) {
      if (rank == 0) {
        for (int i = tid; i < p; i += nt) {
          K[g * p + i] = 0.f;
          u_out[g * p + i] = 0.f;
        }
        for (int l = tid; l < W; l += nt) Eg[l] = 0.f;
      }
      continue;
    }
    if (tid == 0) s_ncols = 0;
    for (int i = tid; i < w.np; i += nt)
      w.u()[i] = i < p ? (u0 != nullptr ? u0[g * p + i]
                                      : 1.0f / sqrtf((float)p))
                     : 0.f;
    __syncthreads();
    {
      int last = 0;
      for (int l = tid; l < W; l += nt)
        if (mg[l] != 0) last = l + 1;
      last = __reduce_max_sync(DN_FULL, last);
      if (lane == 0 && last > 0) atomicMax(&s_ncols, last);
    }
    __syncthreads();

    const int nch = (s_ncols + CH - 1) / CH;
    Src src;
    src.F = I16 ? (const void*)((const int16_t*)F + g * p * W)
                : (const void*)((const float*)F + g * p * W);
    src.mask = mg;
    src.ss = ss;
    src.rs = rs;
    src.Xg = nullptr;  // (X column by column: w.X)
    src.E = Eg;
    src.W = W;
    src.rank = 0;
    src.cl = 1;
    src.nloc = nch * CH;
    w.X = Xscratch + g * W * w.ldx;

    float s;
    // (its blocks share the power step past T = 5)
    pcl_core<false, true>(src, w, s, nmf_iter, power_cold, power_warm,
                          warm_plain);
    if (rank == 0) {
      for (int l = nch * CH + tid; l < W; l += nt) Eg[l] = 0.f;
      for (int i = tid; i < p; i += nt) {
        K[g * p + i] = w.u()[i] * s;
        u_out[g * p + i] = w.u()[i];
      }
    }
    __syncthreads();  // u and s_ncols are read before the next gene
  }
}

int dn_stream_panel(const StreamArgs& a) {
  if (a.threads != DN_WIDE_THREADS || a.cl != 1 || a.p < DN_PANEL_MIN_P)
    return (int)cudaErrorInvalidValue;
  if (dn_pcl_on(a.p, DN_PCL_STREAM)) {
    // blocks of several pairs keep them in the workspace
    if (dn_pcl_held(a.p) > 1 && a.ws == nullptr)
      return (int)cudaErrorInvalidValue;
#define DN_STREAM_PCL_ARGS                                                    \
  DN_PCL_STREAM,                                                              \
  a.G, a.p, a.ws_slots, (size_t)dn_pcl_smem_floats(a.p), a.st, a.F, a.mask,   \
      a.act, a.scale, a.u0, a.X, a.K, a.E, a.u, a.G, a.p, a.W, a.nmf_iter,    \
      a.power_cold, a.power_warm, a.warm_plain,                               \
      dn_pcl_held(a.p) > 1 ? a.ws : nullptr
    if (a.scale != nullptr)
      return launch_pcl(nmf_stream_panel_kernel<true>, DN_STREAM_PCL_ARGS);
    return launch_pcl(nmf_stream_panel_kernel<false>, DN_STREAM_PCL_ARGS);
#undef DN_STREAM_PCL_ARGS
  }
  return dn_stream_phase(a);
}

// The clusters the card holds at once of kernel 4 at p on the cluster layout
// (its int16 + scale instance where f_is_i16, else its float32 one), or a
// negative CUDA error: what launch_pcl launches at most.
extern "C" int dn_stream_panel_clusters(int p, int f_is_i16) {
  if (!dn_pcl_on(p, DN_PCL_STREAM)) return -(int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int fit = 0;
  const size_t smem = (size_t)dn_pcl_smem_floats(p);
  const int e = f_is_i16 ? pcl_occupancy(nmf_stream_panel_kernel<true>, p,
                                         smem, cfg, attr, fit)
                         : pcl_occupancy(nmf_stream_panel_kernel<false>, p,
                                         smem, cfg, attr, fit);
  return e != 0 ? -e : fit;
}
