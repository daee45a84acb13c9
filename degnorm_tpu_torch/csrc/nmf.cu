// Kernel 1: the Lagrangian NMF-OA loop, one thread block per gene.
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
// sweep at the occupancy its registers allow (common.cuh).  The loop is
// common.cuh's nmf_core with X in a global scratch, as in kernel 3
// (trim.cu); a block has a thread per 16 columns (ops/cuda_nmf.py).  The TPU
// kernel's block-level skip of inactive genes becomes a per-gene early
// return that writes zeros (callers gate every use).  Several short genes a
// block, for the initial fit of a narrow bucket, is this kernel's open
// redesign.
#include "common.cuh"

template <int PMAX, bool FULL>
__global__ void __launch_bounds__(32 * dn_max_warps<PMAX>(), 1)
    nmf_masked_kernel(const float* __restrict__ F,
                      const uint8_t* __restrict__ mask,
                      const uint8_t* __restrict__ act,
                      const float* __restrict__ u0, float* Xscratch,
                      float* __restrict__ K, float* __restrict__ E,
                      float* __restrict__ u, int p, int W, int nmf_iter,
                      int power_cold, int power_warm, int warm_plain) {
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
    return;
  }
  float u_lane = 0.f;
  if (lane < p)
    u_lane = u0 != nullptr ? u0[g * p + lane] : 1.0f / sqrtf((float)p);
  ResidentSrc<PMAX, FULL> src{F + g * p * W, mask + g * W, Xscratch + g * p * W,
                        Eg, p, W};
  float s;
  nmf_core<PMAX>(src, red, tiles, u_lane, s, nmf_iter, power_cold, power_warm,
                 warm_plain);
  if (tid < p) {
    K[g * p + tid] = u_lane * s;
    u[g * p + tid] = u_lane;
  }
}

// X: (G, p, W) float32 scratch.
extern "C" int dn_nmf_masked(const float* F, const uint8_t* mask,
                             const uint8_t* act, const float* u0, float* X,
                             float* K, float* E, float* u, int G, int p, int W,
                             int nmf_iter, int power_cold, int power_warm,
                             int warm_plain, int threads, void* stream) {
  if (threads % 32 != 0 || threads < 32 || threads > 512)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define CALL(PM, FULL)                                                        \
  do {                                                                        \
    if (threads > 32 * dn_max_warps<PM>()) return (int)cudaErrorInvalidValue; \
    const size_t dyn = sizeof(float) * gram_tile_floats<PM>(threads / 32);    \
    cudaError_t e = cudaFuncSetAttribute(                                     \
        nmf_masked_kernel<PM, FULL>,                                          \
        cudaFuncAttributeMaxDynamicSharedMemorySize,                          \
        (int)dyn);                                                            \
    if (e != cudaSuccess) return (int)e;                                      \
    nmf_masked_kernel<PM, FULL><<<G, threads, dyn, st>>>(                     \
        F, mask, act, u0, X, K, E, u, p, W, nmf_iter, power_cold,             \
        power_warm, warm_plain);                                              \
  } while (0)
  DN_DISPATCH_P(p, CALL);
#undef CALL
  return (int)cudaGetLastError();
}
