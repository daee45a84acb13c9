// Kernel 1: the Lagrangian NMF-OA loop, one thread block per gene or one warp
// per gene.  The kernels and their launches; the C entry points are nmf.cu,
// the default instances are compiled there and the nmf_tol ones (ADAPT) in
// nmf_tol.cu, side by side.
//
// Replaces the TPU kernel degnorm_tpu/ops/pallas_nmf.py::nmf_masked_pallas
// (_nmf_kernel / _nmf_loop).  Computes, per gene: A0 = F * mask; a cold
// rank-1 from the p x p Gram (squared power iteration, or resumed from u0);
// nmf_iter times X <- max(X - (u (x) v - A0) / sqrt(nmf_iter), A0) with a
// warm refit of u and v = X^T u; finally s = sqrt(u^T B u), K = u s,
// E = v / s.
//
// Bound on this card: float32 operations (about nmf_iter * (p(p+1) + 8p)
// per active column against 4p bytes read), in practice the latency of a
// sweep at the occupancy its registers allow (common.cuh).  Two launches of
// common.cuh's nmf_core, chosen by shape in ops/cuda_nmf.py::
// pick_nmf_geometry:
//   * nmf_masked_kernel: one block a gene, a thread per 16 columns, X in a
//     global scratch, as in kernel 3 (trim.cu).  For few genes of many
//     columns (the W = 4096 bucket: fewer genes than the card has warps).
//   * nmf_masked_warp_kernel: one WARP a gene, several warps a block, for
//     many short genes (the W = 1024 bucket: about 376 active columns a
//     gene).  What a sweep costs besides its columns (the Gram reduction,
//     the p x p power step) is paid by one warp instead of every warp of a
//     block, and there is no block barrier: the warp's butterfly is the
//     gene's whole Gram (WarpRed).  The warp first compacts the gene's
//     active columns (a ballot a group of 32) into a list of uint16 column
//     indices in its shared memory, so that every sweep walks ceil(n / 32)
//     groups with all lanes on and X sits at compact positions, coalesced
//     (CompactSrc).  Warps are persistent: each takes its next gene from a
//     counter the wrapper zeroes, so an inactive gene (padding, bailed)
//     frees its warp at once; a gene is computed by one warp whichever warp
//     takes it, so the result does not depend on the schedule.  Where shared
//     memory is left at the occupancy the registers allow, X and then A0 of
//     a gene's first active columns stay there (`warp_floats`).
// The TPU kernel's block-level skip of inactive genes becomes a per-gene
// early return that writes zeros (callers gate every use).
//
// EngineConfig.nmf_tol > 0 (the TPU kernel's adaptive branch,
// pallas_nmf.py:440-499) is the ADAPT instance of either launch (see
// common.cuh::nmf_core): a gene that freezes leaves its own loop, so the
// batch's early exit comes free, and `iters` (where given) receives each
// gene's iterations run (0 for an inactive gene).
#pragma once
#include "common.cuh"

// Arguments of both launches.  X: (G, p, W) float32 scratch; next: one
// int32, zero at the launch (the warp launch only); iters: (G) int32 or null.
struct NmfArgs {
  const float* F;
  const uint8_t* mask;
  const uint8_t* act;
  const float* u0;
  int* next;
  float* X;
  float* K;
  float* E;
  float* u;
  int* iters;
  int G, p, W, nmf_iter, power_cold, power_warm, warm_plain;
  float tol;
  int threads;
  cudaStream_t stream;
  float* ws = nullptr;  // p > 128: the panel instance's workspace
  int ws_slots = 0;     // (nmf.cu)
};


template <int PMAX, bool FULL, bool ADAPT>
__global__ void __launch_bounds__(32 * dn_max_warps<PMAX>(), 1)
    nmf_masked_kernel(const float* __restrict__ F,
                      const uint8_t* __restrict__ mask,
                      const uint8_t* __restrict__ act,
                      const float* __restrict__ u0, float* Xscratch,
                      float* __restrict__ K, float* __restrict__ E,
                      float* __restrict__ u, int* __restrict__ iters, int p,
                      int W, int nmf_iter, int power_cold, int power_warm,
                      int warm_plain, float tol) {
  __shared__ BlockRed<PMAX> red;
  extern __shared__ float tiles[];  // Gram tiles (p >= 16)
  const size_t g = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  float* Eg = E + g * W;
  if (act != nullptr && act[g] == 0) {
    if (tid < p) {
      K[g * p + tid] = 0.f;
      u[g * p + tid] = 0.f;
    }
    for (int w = tid; w < W; w += blockDim.x) Eg[w] = 0.f;
    if (tid == 0 && iters != nullptr) iters[g] = 0;
    return;
  }
  float u_lane = 0.f;
  if (lane < p)
    u_lane = u0 != nullptr ? u0[g * p + lane] : 1.0f / sqrtf((float)p);
  ResidentSrc<PMAX, FULL> src{F + g * p * W, mask + g * W, Xscratch + g * p * W,
                        Eg, p, W};
  float s;
  int ran;
  nmf_core<PMAX, BlockGeo, ADAPT>(src, red, tiles, u_lane, s, nmf_iter,
                                  power_cold, power_warm, warm_plain, tol,
                                  &ran);
  if (tid < p) {
    K[g * p + tid] = u_lane * s;
    u[g * p + tid] = u_lane;
  }
  if (tid == 0 && iters != nullptr) iters[g] = ran;
}

// Floats of dynamic shared memory one warp of nmf_masked_warp_kernel takes:
// its Gram (NG), its Gram tile and copy of u (p >= 16), `warp_floats` for X
// and A0, then W uint16 column indices.
template <int PMAX>
__host__ __device__ constexpr size_t warp_gene_floats(int W, int warp_floats) {
  return (size_t)PMAX * (PMAX + 1) / 2 + warp_work_floats<PMAX>() +
         (size_t)warp_floats + ((size_t)W + 1) / 2;
}

template <int PMAX, bool FULL, bool ADAPT>
__global__ void __launch_bounds__(32 * dn_max_warps<PMAX>(), 1)
    nmf_masked_warp_kernel(const float* __restrict__ F,
                           const uint8_t* __restrict__ mask,
                           const uint8_t* __restrict__ act,
                           const float* __restrict__ u0,
                           int* __restrict__ next, float* Xscratch,
                           float* __restrict__ K, float* __restrict__ E,
                           float* __restrict__ u, int* __restrict__ iters,
                           int G, int p, int W, int nmf_iter, int power_cold,
                           int power_warm, int warm_plain, float tol,
                           int warp_floats) {
  constexpr int NG = PMAX * (PMAX + 1) / 2;
  extern __shared__ float dyn[];
  const int lane = threadIdx.x & 31;
  float* mine = dyn + (size_t)(threadIdx.x >> 5) *
                          warp_gene_floats<PMAX>(W, warp_floats);
  WarpRed<PMAX> red{mine};
  float* work = mine + NG;  // Gram tile and u (p >= 16)
  float* room = work + warp_work_floats<PMAX>();
  uint16_t* idx = (uint16_t*)(room + warp_floats);
  const unsigned below = (1u << lane) - 1u;

  for (;;) {
    __syncwarp();  // the last gene's reads of idx are done
    int k = 0;
    if (lane == 0) k = atomicAdd(next, 1);
    k = __shfl_sync(DN_FULL, k, 0);
    if (k >= G) break;
    const size_t g = k;
    float* Eg = E + g * W;
    if (act != nullptr && act[g] == 0) {
      if (lane < p) {
        K[g * p + lane] = 0.f;
        u[g * p + lane] = 0.f;
      }
      for (int w = lane; w < W; w += 32) Eg[w] = 0.f;
      if (lane == 0 && iters != nullptr) iters[g] = 0;
      continue;
    }
    // compaction: the active columns in order, E zero at the others
    const uint8_t* mg = mask + g * W;
    int n = 0;
    for (int w0 = 0; w0 < W; w0 += 32) {
      const int w = w0 + lane;
      const bool on = w < W && mg[w] != 0;
      const unsigned b = __ballot_sync(DN_FULL, on);
      if (on)
        idx[n + __popc(b & below)] = (uint16_t)w;
      else if (w < W)
        Eg[w] = 0.f;
      n += __popc(b);
    }
    __syncwarp();
    CompactSrc<PMAX, FULL> src;
    src.F = F + g * p * W;
    src.idx = idx;
    src.Xg = Xscratch + g * p * W;
    src.E = Eg;
    src.p = p;
    src.W = W;
    src.n = n;
    // the room to X first (read and written every sweep), then to A0, in
    // whole groups of 32 slots
    const int fit_x = (warp_floats / p) & ~31;
    src.xcap = n < fit_x ? n : fit_x;
    const int fit_a = ((warp_floats - src.xcap * p) / p) & ~31;
    src.acap = n < fit_a ? n : fit_a;
    src.Xs = room;
    src.As = room + src.xcap * p;

    float u_lane = 0.f;
    if (lane < p)
      u_lane = u0 != nullptr ? u0[g * p + lane] : 1.0f / sqrtf((float)p);
    float s;
    int ran;
    // a frozen gene (ADAPT) leaves its own loop; the warp goes on to its
    // next gene
    nmf_core<PMAX, WarpGeo, ADAPT>(src, red, work, u_lane, s, nmf_iter,
                                   power_cold, power_warm, warm_plain, tol,
                                   &ran);
    if (lane < p) {
      K[g * p + lane] = u_lane * s;
      u[g * p + lane] = u_lane;
    }
    if (lane == 0 && iters != nullptr) iters[g] = ran;
  }
}

template <bool ADAPT>
int launch_block(const NmfArgs& a) {
  if (a.threads % 32 != 0 || a.threads < 32 || a.threads > 512)
    return (int)cudaErrorInvalidValue;
#define CALL(PM, FULL)                                                        \
  do {                                                                        \
    if (a.threads > 32 * dn_max_warps<PM>())                                  \
      return (int)cudaErrorInvalidValue;                                      \
    const size_t dyn = sizeof(float) * gram_tile_floats<PM>(a.threads / 32);  \
    cudaError_t e = cudaFuncSetAttribute(                                     \
        nmf_masked_kernel<PM, FULL, ADAPT>,                                   \
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);               \
    if (e != cudaSuccess) return (int)e;                                      \
    nmf_masked_kernel<PM, FULL, ADAPT><<<a.G, a.threads, dyn, a.stream>>>(    \
        a.F, a.mask, a.act, a.u0, a.X, a.K, a.E, a.u, a.iters, a.p, a.W,      \
        a.nmf_iter, a.power_cold, a.power_warm, a.warm_plain, a.tol);         \
  } while (0)
  DN_DISPATCH_P(a.p, CALL);
#undef CALL
  return (int)cudaGetLastError();
}

// The warp-a-gene launch: `threads` / 32 warps a block, as many blocks as
// are resident on the card at once (every warp loops over genes), at most
// one warp a gene.  X and A0 get what shared memory an SM has left at the
// occupancy the registers and the other shared memory allow.  `next`: one
// int, zero at the launch.
template <int PM, bool FULL, bool ADAPT>
static int launch_warp(const NmfArgs& a) {
  const int G = a.G, p = a.p, W = a.W, threads = a.threads;
  // p <= 16 only: the PMAX = 32 instance spilled (a block a gene takes it)
  if constexpr (PM > 16) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (threads > 32 * dn_max_warps<PM>()) return (int)cudaErrorInvalidValue;
    auto kern = nmf_masked_warp_kernel<PM, FULL, ADAPT>;
    const int warps = threads / 32;
    int dev = 0, sms = 0, smem_sm = 0, smem_blk = 0, reserved = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(
          &smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&smem_blk,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&reserved,
                                 cudaDevAttrReservedSharedMemoryPerBlock, dev);
    cudaFuncAttributes fa;
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_blk - (int)fa.sharedSizeBytes);
    if (e != cudaSuccess) return (int)e;
    const size_t base = sizeof(float) * warps * warp_gene_floats<PM>(W, 0);
    int blocks_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_sm, kern, threads,
                                                      base);
    if (e != cudaSuccess) return (int)e;
    if (blocks_sm < 1) return (int)cudaErrorInvalidConfiguration;
    // what an SM has left at this occupancy, shared by its blocks' warps, in
    // whole groups of 32 slots of X at p rows, as the kernel uses them
    const long long blk = (long long)smem_sm / blocks_sm - reserved -
                          (long long)fa.sharedSizeBytes - (long long)base;
    const long long cap = (long long)smem_blk - (long long)fa.sharedSizeBytes -
                          (long long)base;
    const long long room = blk < cap ? blk : cap;
    int warp_floats =
        room > 0 ? (int)(room / (long long)sizeof(float) / warps) : 0;
    warp_floats = warp_floats / (32 * p) * (32 * p);
    const size_t dyn =
        sizeof(float) * warps * warp_gene_floats<PM>(W, warp_floats);
    const int grid_max = blocks_sm * sms;
    const int grid_need = (G + warps - 1) / warps;
    const int grid = grid_need < grid_max ? grid_need : grid_max;
    kern<<<grid, threads, dyn, a.stream>>>(
        a.F, a.mask, a.act, a.u0, a.next, a.X, a.K, a.E, a.u, a.iters, G, p,
        W, a.nmf_iter, a.power_cold, a.power_warm, a.warm_plain, a.tol,
        warp_floats);
    return (int)cudaGetLastError();
  }
}

template <bool ADAPT>
int launch_warp_any(const NmfArgs& a) {
  if (a.threads % 32 != 0 || a.threads < 32 || a.threads > 512 ||
      a.W > 65535)
    return (int)cudaErrorInvalidValue;
  if (a.G == 0) return 0;
  int code = 0;
#define CALL(PM, FULL) code = launch_warp<PM, FULL, ADAPT>(a)
  DN_DISPATCH_P(a.p, CALL);
#undef CALL
  return code;
}

// the nmf_tol instances (nmf_tol.cu)
int dn_nmf_block_tol(const NmfArgs& a);
int dn_nmf_warp_tol(const NmfArgs& a);
// the block launch for 33 <= p <= 128 (nmf_wide.cuh: nmf_wide.cu and, for
// nmf_tol, nmf_wide_tol.cu)
int dn_nmf_wide(const NmfArgs& a);
int dn_nmf_wide_tol(const NmfArgs& a);
// the block launch for p > 128 (nmf_panel.cu: panel.cuh's core), both
// branches
int dn_nmf_panel(const NmfArgs& a);
