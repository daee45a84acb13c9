// Kernel 2 for p > 128 samples: ratio-SVD row sums, one thread block of
// DN_WIDE_THREADS a gene at a time, coverage read as it is stored (raw int16
// or float32), the panel Gram and power step of panel.cuh; both input forms
// in this one translation unit.  The C entry point stays ratio.cu's
// dn_ratio_rowsums, which hands p > 128 here.
//
// Replaces, for studies of more than 128 samples, the TPU kernel
// degnorm_tpu/ops/pallas_nmf.py::ratio_rowsums_pallas (_ratio_kernel), as
// ratio_wide.cuh does for 33 <= p <= 128: A0 = F * mask, one cold rank-1
// (K, E), the row sums of A0 and of max(K (x) E, A0).  Bound on this card:
// float32 operations (the Gram's p(p+1) a column against 2p bytes of
// int16).  Pass 1 is the panel pairs' Gram of A0, whose diagonal passes
// also sum A0's rows; pass 2 takes each tile's v over all rows and stages
// max(K E, A0) a panel at a time, thread t < 128 adding its row of the
// panel in column order.  A value is (float)raw for int16, which is exact,
// and every operation after the load is the same for both forms in the
// same order, so int16 input gives the bits of float32 input holding the
// same values.
#include "panel.cuh"
#include "ratio.cuh"

template <bool I16>
__global__ void __launch_bounds__(DN_WIDE_THREADS, 1)
    ratio_panel_kernel(const void* __restrict__ Fv,
                       const uint8_t* __restrict__ mask,
                       float* __restrict__ cov_sums,
                       float* __restrict__ est_sums, int G, int p, int W,
                       int power_cold, float* ws) {
  using T = typename std::conditional<I16, int16_t, float>::type;
  constexpr int TC = DN_WIDE_TC, LD = DN_PANEL_LD;
  extern __shared__ float4 dyn4[];
  const int t = threadIdx.x, q = t >> 6, c = t & (TC - 1);
  PanelWork w;
  w.init((float*)dyn4, ws + blockIdx.x * dn_panel_ws_floats(p), p);
  float* cov = w.x[0];  // row sums of A0
  float* est = w.x[1];  // row sums of max(K E, A0)
  WideGram<128> gr;
  for (size_t g = blockIdx.x; g < (size_t)G; g += gridDim.x) {
    const T* Fg = (const T*)Fv + g * p * W;
    const uint8_t* mg = mask + g * W;
    const auto on_fn = [&](int l) { return mg[l] != 0; };
    const auto a0 = [&](int l, int i) {
      return ratio_val(Fg[(size_t)i * W + l]);
    };

    // pass 1: Gram of A0 and its row sums
    panel_gram<true>(w, gr, W, w.B, on_fn, a0, cov);
    for (int i = t; i < w.np; i += DN_WIDE_THREADS) {
      w.u[i] = i < p ? 1.0f / sqrtf((float)p) : 0.f;
      est[i] = 0.f;
    }
    __syncthreads();
    for (int i = t; i < p; i += DN_WIDE_THREADS) cov_sums[g * p + i] = cov[i];
    float s;
    panel_refit(w, gr, power_cold, 0, true, s);
    for (int i = t; i < w.np; i += DN_WIDE_THREADS) w.uo[i] = w.u[i] * s;  // K
    __syncthreads();

    // pass 2: row sums of max(K E, A0) over the active columns
    const float den = s + DN_EPS;
    for (int l0 = 0; l0 < W; l0 += TC) {
      const int l = l0 + c;
      const bool on = l < W && mg[l] != 0;
      float vp = 0.f;
      if (on) {
        for (int P = 0; P < w.T; ++P)
#pragma unroll 4
          for (int j = 0; j < 32; ++j) {
            const int i = P * DN_PANEL_ROWS + q * 32 + j;
            if (i < p) vp = fmaf(a0(l, i), w.u[i], vp);
          }
      }
      w.vpart[q * TC + c] = vp;
      if (!__syncthreads_or(on)) continue;
      const float v = ((w.vpart[c] + w.vpart[TC + c]) + w.vpart[2 * TC + c]) +
                      w.vpart[3 * TC + c];
      const float e = v / den;
      for (int P = 0; P < w.T; ++P) {
        panel_stage(w.SI, P, p, on,
                    [&](int i) { return fmaxf(w.uo[i] * e, a0(l, i)); });
        __syncthreads();
        const int i = P * DN_PANEL_ROWS + t;
        if (t < DN_PANEL_ROWS && i < p) {
          float es = est[i];
          for (int k = 0; k < TC; ++k) es += w.SI[k * LD + t];
          est[i] = es;
        }
        __syncthreads();  // S and vpart are read before they are written
      }
    }
    __syncthreads();
    for (int i = t; i < p; i += DN_WIDE_THREADS) est_sums[g * p + i] = est[i];
    __syncthreads();  // the vectors are read before the next gene writes them
  }
}

int dn_ratio_panel(const RatioArgs& a, int f_is_i16) {
  if (a.threads != DN_WIDE_THREADS || a.cl != 1 || a.p < DN_PANEL_MIN_P ||
      a.ws == nullptr)
    return (int)cudaErrorInvalidValue;
#define DN_RATIO_PANEL_ARGS                                                   \
  a.G, a.ws_slots, 0, a.st, a.F, a.mask, a.cov, a.est, a.G, a.p, a.W,         \
      a.power_cold, a.ws
  if (f_is_i16)
    return launch_panel(ratio_panel_kernel<true>, DN_RATIO_PANEL_ARGS);
  return launch_panel(ratio_panel_kernel<false>, DN_RATIO_PANEL_ARGS);
#undef DN_RATIO_PANEL_ARGS
}
