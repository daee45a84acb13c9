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
// per active column against 4p bytes read).  The design keeps the wide
// axis to ONE pass per iteration and the Gram reduction deterministic; see
// common.cuh.  The TPU kernel's block-level skip of inactive genes becomes
// a per-gene early return that writes zeros (callers gate every use).
#include "common.cuh"

template <int PMAX>
__global__ void nmf_masked_kernel(const float* __restrict__ F,
                                  const uint8_t* __restrict__ mask,
                                  const uint8_t* __restrict__ act,
                                  const float* __restrict__ u0,
                                  float* __restrict__ X, float* __restrict__ K,
                                  float* __restrict__ E, float* __restrict__ u,
                                  int p, int W, int nmf_iter, int power_cold,
                                  int power_warm, int warm_plain) {
  __shared__ NmfSmem<PMAX> sm;
  const size_t g = blockIdx.x;
  const int tid = threadIdx.x;
  float* Eg = E + g * W;
  if (act != nullptr && act[g] == 0) {
    if (tid < p) {
      K[g * p + tid] = 0.f;
      u[g * p + tid] = 0.f;
    }
    for (int w = tid; w < W; w += blockDim.x) Eg[w] = 0.f;
    return;
  }
  if (tid < PMAX) {
    float start = u0 != nullptr ? (tid < p ? u0[g * p + tid] : 0.f)
                                : 1.0f / sqrtf((float)p);
    sm.u[tid] = tid < p ? start : 0.f;
  }
  __syncthreads();
  nmf_loop<PMAX>(sm, F + g * p * W, mask + g * W, X + g * p * W, Eg, p, W,
                 nmf_iter, power_cold, power_warm, warm_plain);
  if (tid < p) {
    K[g * p + tid] = sm.K[tid];
    u[g * p + tid] = sm.u[tid];
  }
}

extern "C" int dn_nmf_masked(const float* F, const uint8_t* mask,
                             const uint8_t* act, const float* u0, float* X,
                             float* K, float* E, float* u, int G, int p, int W,
                             int nmf_iter, int power_cold, int power_warm,
                             int warm_plain, int threads, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define CALL(PM)                                                           \
  nmf_masked_kernel<PM><<<G, threads, 0, st>>>(F, mask, act, u0, X, K, E, \
                                               u, p, W, nmf_iter,         \
                                               power_cold, power_warm,    \
                                               warm_plain)
  DN_DISPATCH_P(p, CALL);
#undef CALL
  return (int)cudaGetLastError();
}
