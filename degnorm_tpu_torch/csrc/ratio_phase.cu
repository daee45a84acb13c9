// Kernel 2 past DN_PCL_MAX_P_STREAM samples: ratio-SVD row sums on
// phase.cuh's phased layout, coverage read as it is stored (raw int16 or
// float32), both forms in this one translation unit.  ratio_panel.cu's
// dn_ratio_panel hands p past its cluster layout here.
//
// Replaces, for studies of more than 1,152 samples, the TPU kernel
// degnorm_tpu/ops/pallas_nmf.py::ratio_rowsums_pallas (_ratio_kernel), as
// ratio_panel.cu does up to 1,152: A0 = F * mask, one cold rank-1 (K, E),
// the row sums of A0 and of max(K (x) E, A0), with its block layout's
// bits.  Bound on this card: the Gram's float32 operations (the rows'
// p(p+1) a column against 2p bytes of int16).  A call: one launch to list
// the genes, then for each group of at most `slots` the Gram of A0 (whose
// diagonal pairs sum A0's rows), B^2, the cold power step, e = v / (s +
// eps) a column, and the row sums of max(K e, A0): 5 launches a group.
#include "phase.cuh"
#include "ratio.cuh"

// The row sums of max(K e, A0) over the active columns of panel P of the
// slot's gene: block (P, slot), each active tile staged as panel_stage
// stages it (zero off the mask and past p), thread t < 128 adding row
// P * 128 + t in column order, as the block layout summed them.
template <bool I16>
__global__ void __launch_bounds__(DN_WIDE_THREADS)
    phase_est_kernel(PhaseArgs a) {
  using AT = typename std::conditional<I16, int16_t, float>::type;
  constexpr int TC = DN_WIDE_TC, LD = DN_PANEL_LD, R = DN_PANEL_ROWS;
  __shared__ __align__(16) float S[TC * LD];
  __shared__ float Kp[R];
  const int t = threadIdx.x, c = t & (TC - 1);
  const int g = phase_gene(a, blockIdx.y);
  if (g < 0) return;
  const int p = a.p, W = a.W, P = blockIdx.x, i0 = P * R;
  const PhaseSlot sl(a.ws, blockIdx.y, p);
  const float s = sl.scal[0];
  if (t < R) Kp[t] = i0 + t < p ? sl.u[i0 + t] * s : 0.f;  // K
  const uint8_t* mg = a.mask + (size_t)g * W;
  const AT* Fg = (const AT*)a.F + (size_t)g * p * W;
  const float* e = sl.B;  // e of the active columns (phase_cols_kernel)
  float es = 0.f;
  for (int l0 = 0; l0 < W; l0 += TC) {
    const int l = l0 + c;
    const bool on = l < W && mg[l] != 0;
    if (!__syncthreads_or(on)) continue;  // (K is visible after the first)
    const float el = on ? e[l] : 0.f;
    panel_stage(S, P, p, on, [&](int i) {
      return fmaxf(Kp[i - i0] * el, ratio_val(Fg[(size_t)i * W + l]));
    });
    __syncthreads();
    if (t < R && i0 + t < p)
      for (int k = 0; k < TC; ++k) es += S[k * LD + t];
    __syncthreads();  // S is read before the next tile writes it
  }
  if (t < R && i0 + t < p) a.est[(size_t)g * p + i0 + t] = es;
}

template <bool I16>
static int ratio_phase(const RatioArgs& a) {
  PhaseArgs pa = {};
  pa.F = a.F;
  pa.mask = a.mask;
  pa.cov = a.cov;
  pa.est = a.est;
  pa.G = a.G;
  pa.p = a.p;
  pa.W = a.W;
  phase_parts(pa, a.ws, a.ws_slots, false);
  const int S = a.ws_slots;
  int e = phase_prep(pa, nullptr, nullptr, S, a.st);
  const unsigned tiles = (unsigned)((a.W + DN_WIDE_TC - 1) / DN_WIDE_TC);
  const unsigned cols = tiles > 0 ? tiles : 1;
  for (int base = 0; e == 0 && base < a.G; base += S) {
    pa.base = base;
    e = phase_launch(phase_gram_kernel<DN_PH_A0, I16>,
                     (unsigned)dn_pcl_pairs(a.p), S,
                     sizeof(float) * dn_phase_gram_floats(), false, a.st, pa);
    if (e == 0) e = phase_power(pa, S, a.power_cold, 0, 1, 1, true, a.st);
    if (e == 0)
      e = phase_launch(phase_cols_kernel<DN_PHC_RATIO, I16>, cols, S, 0,
                       false, a.st, pa);
    if (e == 0)
      e = phase_launch(phase_est_kernel<I16>, (unsigned)dn_pcl_T(a.p), S, 0,
                       false, a.st, pa);
  }
  return e;
}

int dn_ratio_phase(const RatioArgs& a, int f_is_i16) {
  // e of a gene's columns goes where its B was (2 p ldb floats)
  if (!dn_phase_on(a.p, DN_PCL_STREAM) || !phase_fits(a.p) || a.ws == nullptr ||
      a.ws_slots < 1 || (size_t)a.W > 2 * (size_t)a.p * dn_phase_ldb(a.p))
    return (int)cudaErrorInvalidValue;
  if (a.G == 0) return 0;
  return f_is_i16 ? ratio_phase<true>(a) : ratio_phase<false>(a);
}
