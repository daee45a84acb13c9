// Kernel 2: ratio-SVD row sums, one thread block per gene.
//
// Replaces the TPU kernel degnorm_tpu/ops/pallas_nmf.py::ratio_rowsums_pallas
// (_ratio_kernel).  Computes, per gene: A0 = F * mask, one cold rank-1
// (K, E), est = max(K (x) E, A0), and the row sums of A0 and of est — the
// inputs of the DegNorm initialisation (reference nmf.py:109-121,522-526).
//
// Bound on this card: bytes (each column costs about p(p+1) + 6p operations
// against 4p bytes).  The gene is read twice (Gram pass, clip pass); the
// second read of a <= 128 KB gene comes from L2.  There is no scratch and no
// width-sized buffer, so any W is taken: a wide gene (megabytes) costs one
// block's time and its second read may come from device memory.  Reductions
// as in common.cuh: warp shuffles, then a fixed-order sum over warps.
#include "common.cuh"

template <int PMAX>
__global__ void ratio_rowsums_kernel(const float* __restrict__ F,
                                     const uint8_t* __restrict__ mask,
                                     float* __restrict__ cov_sums,
                                     float* __restrict__ est_sums, int p, int W,
                                     int power_cold) {
  constexpr int NG = NmfSmem<PMAX>::NG;
  __shared__ NmfSmem<PMAX> sm;
  const size_t g = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5;
  const float* Fg = F + g * p * W;
  const uint8_t* mg = mask + g * W;

  if (tid < PMAX) sm.u[tid] = tid < p ? 1.0f / sqrtf((float)p) : 0.f;

  // pass 1: Gram of A0 and its row sums
  float acc[NG + PMAX];
#pragma unroll
  for (int k = 0; k < NG + PMAX; ++k) acc[k] = 0.f;
  for (int w = tid; w < W; w += nt) {
    if (mg[w] == 0) continue;
    float x[PMAX];
#pragma unroll
    for (int i = 0; i < PMAX; ++i) {
      x[i] = i < p ? Fg[(size_t)i * W + w] : 0.f;
      acc[NG + i] += x[i];
    }
    gram_accumulate<PMAX>(x, acc);
  }
  block_reduce<NG + PMAX>(acc, sm.part, sm.red);
  if (warp == 0) {
    if (tid < p) cov_sums[g * p + tid] = sm.red[NG + tid];
    warp0_refit<PMAX>(sm, power_cold);
  }
  __syncthreads();

  // pass 2: row sums of max(K E, A0)
  float K[PMAX], u[PMAX], es[PMAX];
#pragma unroll
  for (int i = 0; i < PMAX; ++i) {
    K[i] = sm.K[i];
    u[i] = sm.u[i];
    es[i] = 0.f;
  }
  const float s = sm.s;
  for (int w = tid; w < W; w += nt) {
    if (mg[w] == 0) continue;
    float a[PMAX];
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < PMAX; ++i) {
      a[i] = i < p ? Fg[(size_t)i * W + w] : 0.f;
      v = fmaf(a[i], u[i], v);
    }
    const float e = v / (s + DN_EPS);
#pragma unroll
    for (int i = 0; i < PMAX; ++i) es[i] += fmaxf(K[i] * e, a[i]);
  }
  block_reduce<PMAX>(es, sm.part, sm.red);
  if (tid < p) est_sums[g * p + tid] = sm.red[tid];
}

extern "C" int dn_ratio_rowsums(const float* F, const uint8_t* mask,
                                float* cov_sums, float* est_sums, int G, int p,
                                int W, int power_cold, int threads,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define CALL(PM, FULL)                                                        \
  ratio_rowsums_kernel<PM><<<G, threads, 0, st>>>(F, mask, cov_sums,          \
                                                  est_sums, p, W, power_cold)
  DN_DISPATCH_P(p, CALL);
#undef CALL
  return (int)cudaGetLastError();
}
