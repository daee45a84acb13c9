// Kernel 2 for 33 <= p <= 128 samples: ratio-SVD row sums, one thread block
// of DN_WIDE_THREADS a gene, coverage read as it is stored (raw int16 or
// float32), the Gram and the power step of wide.cuh.  The C entry point
// stays ratio.cu's dn_ratio_rowsums, which hands p > 32 here; the instances
// are compiled in ratio_wide_f32.cu and ratio_wide_i16.cu, side by side.
//
// Replaces, for wide studies, the TPU kernel degnorm_tpu/ops/pallas_nmf.py::
// ratio_rowsums_pallas (_ratio_kernel), as ratio.cuh does for p <= 32:
// A0 = F * mask, one cold rank-1 (K, E), the row sums of A0 and of
// max(K (x) E, A0).  Bound on this card: float32 operations at p > 32 (the
// Gram's p(p+1) a column against 2p bytes of int16).  Two passes over the
// gene's columns in tiles of DN_WIDE_TC (the second mostly from L2): each
// tile's masked values go into the shared tile S, thread t < PMAX adds S's
// row t to its row sum in column order, and the SYRK adds S to the Gram.  A
// value is (float)raw for int16, which is exact, and every operation after
// the load is the same for both forms in the same order, so int16 input
// gives the bits of float32 input holding the same values.
#pragma once
#include "ratio.cuh"
#include "wide.cuh"

template <int PMAX, bool I16>
__global__ void __launch_bounds__(DN_WIDE_THREADS, dn_wide_min_blocks<PMAX>())
    ratio_wide_kernel(const void* __restrict__ Fv,
                      const uint8_t* __restrict__ mask,
                      float* __restrict__ cov_sums,
                      float* __restrict__ est_sums, int p, int W,
                      int power_cold) {
  using T = typename std::conditional<I16, int16_t, float>::type;
  constexpr int Q = WideShape<PMAX>::Q, LD = WideShape<PMAX>::LD;
  constexpr int TC = DN_WIDE_TC;
  extern __shared__ float4 dyn4[];
  WideWork<PMAX> wk;
  wk.init((float*)dyn4);
  const size_t g = blockIdx.x;
  const int t = threadIdx.x, q = t >> 6, c = t & (TC - 1), i0 = q * Q;
  const T* Fg = (const T*)Fv + g * p * W;
  const uint8_t* mg = mask + g * W;
  float* Sc = wk.S + c * LD + i0;

  // pass 1: Gram of A0 and its row sums
  WideGram<PMAX> gr;
  gr.zero();
  float rs = 0.f;  // thread t < PMAX: row t's sum
  for (int l0 = 0; l0 < W; l0 += TC) {
    const int l = l0 + c;
    const bool on = l < W && mg[l] != 0;
#pragma unroll 2
    for (int k4 = 0; k4 < Q; k4 += 4) {
      float x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + k4 + j;
        x[j] = (on && i < p) ? ratio_val(Fg[(size_t)i * W + l]) : 0.f;
      }
      wide_st<4>(Sc + k4, x);
    }
    if (__syncthreads_or(on)) {  // a tile with no active column adds 0
      if (t < PMAX)
        for (int k = 0; k < TC; ++k) rs += wk.S[k * LD + t];
      gr.template syrk<false>(wk.S, TC, 1.f);
    }
    __syncthreads();
  }
  gr.store(wk.B);
  if (t < PMAX) wk.u[t] = t < p ? 1.0f / sqrtf((float)p) : 0.f;
  __syncthreads();
  if (t < p) cov_sums[g * p + t] = rs;
  float s;
  wide_refit<PMAX>(wk, gr, power_cold, 0, true, s);
  if (t < PMAX) wk.uo[t] = wk.u[t] * s;  // K (zero beyond p)
  __syncthreads();

  // pass 2: row sums of max(K E, A0) over the active columns
  const float den = s + DN_EPS;
  float es = 0.f;
  for (int l0 = 0; l0 < W; l0 += TC) {
    const int l = l0 + c;
    const bool on = l < W && mg[l] != 0;
    // A0 into S (held there across the barrier) and the partial of v
    float vp = 0.f;
#pragma unroll 2
    for (int k4 = 0; k4 < Q; k4 += 4) {
      float x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + k4 + j;
        x[j] = (on && i < p) ? ratio_val(Fg[(size_t)i * W + l]) : 0.f;
        vp = fmaf(x[j], wk.u[i], vp);
      }
      wide_st<4>(Sc + k4, x);
    }
    wk.vpart[q * TC + c] = vp;
    if (!__syncthreads_or(on)) continue;
    if (on) {
      const float v = ((wk.vpart[c] + wk.vpart[TC + c]) + wk.vpart[2 * TC + c]) +
                      wk.vpart[3 * TC + c];
      const float e = v / den;
#pragma unroll 2
      for (int k4 = 0; k4 < Q; k4 += 4) {
        float x[4];
        wide_ld<4>(Sc + k4, x);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = i0 + k4 + j;
          x[j] = i < p ? fmaxf(wk.uo[i] * e, x[j]) : 0.f;
        }
        wide_st<4>(Sc + k4, x);
      }
    }
    __syncthreads();
    if (t < PMAX)
      for (int k = 0; k < TC; ++k) es += wk.S[k * LD + t];
    __syncthreads();  // S and vpart are read before the next tile
  }
  if (t < p) est_sums[g * p + t] = es;
}

template <bool I16>
int launch_ratio_wide(const RatioArgs& a) {
  if (a.threads != DN_WIDE_THREADS || a.cl != 1 || a.p < DN_WIDE_MIN_P ||
      a.p > DN_WIDE_MAX_P)
    return (int)cudaErrorInvalidValue;
  if (a.G == 0) return 0;
#define CALL(PM)                                                             \
  do {                                                                       \
    const size_t dyn = sizeof(float) * wide_core_floats<PM>();               \
    cudaError_t e = cudaFuncSetAttribute(                                    \
        ratio_wide_kernel<PM, I16>,                                          \
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);              \
    if (e != cudaSuccess) return (int)e;                                     \
    ratio_wide_kernel<PM, I16><<<a.G, DN_WIDE_THREADS, dyn, a.st>>>(         \
        a.F, a.mask, a.cov, a.est, a.p, a.W, a.power_cold);                  \
  } while (0)
  DN_DISPATCH_WIDE_P(a.p, CALL);
#undef CALL
  return (int)cudaGetLastError();
}
