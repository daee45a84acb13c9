// Kernel 3 for 33 <= p <= 128 samples: the whole baseline-selection trim
// loop, one thread block of DN_WIDE_THREADS a gene, each round's NMF loop on
// wide.cuh's block-level SYRK layout.  The C entry point stays trim.cu's
// dn_trim_loop, which hands p > 32 here; the default instances are compiled
// in trim_wide.cu, the trim_fast ones in trim_wide_fast.cu and the nmf_tol
// ones in trim_wide_tol.cu, side by side.
//
// Replaces, for wide studies, the TPU kernel degnorm_tpu/ops/pallas_trim.py::
// trim_loop_pallas (_trim_kernel), as trim.cuh does for p <= 32: the same
// rounds, flags, counters and results, and the same opt-in branches as
// instances (MODE: DN_TRIM_FAST's warm-restart rounds from the X the gene
// holds, DN_TRIM_TOL's adaptive freeze).  Bound on this card: float32
// operations (a round is a full NMF loop, see wide.cuh).  Where trim.cuh
// keeps 2p row sums a thread, the DI refresh here gives each warp whole rows
// of the gene (a row's columns are contiguous: coalesced, and a warp sum a
// row in a fixed order).
//
// At the PMAX where dn_res_on holds, kernel 3 runs on wide_res.cuh's
// resident core instead (trim_res_kernel): a cluster of blocks a gene, the
// gene's X in their shared memory for every step of every round (trim_fast's
// warm restarts read the X held), the Gram on the tensor cores by 3xTF32.
// Every block of the cluster runs the round's bookkeeping (residual scores,
// the bin to drop, the DI refresh) on the whole gene itself, in the same
// order, and so takes every decision the others take; E goes through device
// memory between them, behind a cluster barrier.  The X and column-mask
// scratch are not touched.
#pragma once
#include "trim.cuh"
#include "wide_res.cuh"

// one block an SM at every PMAX (the trim loop's own state beside the core
// spilled at 128 registers a thread)
template <int PMAX, int MODE>
__global__ void __launch_bounds__(DN_WIDE_THREADS, 1)
trim_wide_kernel(
    const float* __restrict__ Fm, const int* __restrict__ bin_id,
    const float* __restrict__ bin_count, const float* __restrict__ K0,
    float* E, const float* __restrict__ rho0,
    const float* __restrict__ u0, const int* __restrict__ n_hi0,
    const int* __restrict__ n_bins0, const uint8_t* __restrict__ active0,
    float* Xscratch, uint8_t* colmask,
    float* __restrict__ K_out, float* __restrict__ rho_out,
    uint8_t* __restrict__ ran_bs, int* __restrict__ rounds_out,
    int* __restrict__ iters_out, int p, int W, int B, int nmf_iter,
    int power_resume, int power_warm, int warm_plain, int max_rounds,
    int min_bins, int min_gene_len, float tol) {
  __shared__ float s_K[PMAX];  // K of the last fit (zero beyond p)
  __shared__ float s_rho[PMAX];
  __shared__ float s_rf[PMAX], s_re[PMAX];  // the DI refresh's row sums
  __shared__ float s_cnt[DN_MAX_BINS];
  __shared__ float s_ss[DN_MAX_BINS];
  __shared__ int s_bin_active[DN_MAX_BINS];
  __shared__ int s_n_hi, s_n_bins, s_go;
  // wide.cuh's work space, then the (W) per-column residual scores
  extern __shared__ float4 dyn4[];

  const size_t g = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;

  // loop-never-ran result: K0, rho0, False, 0
  if (active0[g] == 0) {
    if (tid < p) {
      K_out[g * p + tid] = K0[g * p + tid];
      rho_out[g * p + tid] = rho0[g * p + tid];
    }
    if (tid == 0) {
      ran_bs[g] = 0;
      rounds_out[g] = 0;
      if (iters_out != nullptr) iters_out[g] = 0;
    }
    return;
  }

  WideWork<PMAX> wk;
  wk.init((float*)dyn4);
  float* s_res = (float*)dyn4 + wide_sync_floats<PMAX>();
  const int* bid = bin_id + g * W;
  float* Eg = E + g * W;
  uint8_t* cm = colmask + g * W;
  const float* Fg = Fm + g * p * W;
  float* Xg = Xscratch + g * p * W;

  if (tid < PMAX) {
    wk.u[tid] = tid < p ? u0[g * p + tid] : 0.f;
    s_K[tid] = tid < p ? K0[g * p + tid] : 0.f;
    s_rho[tid] = tid < p ? rho0[g * p + tid] : 0.f;
  }
  for (int b = tid; b < B; b += nt) {
    s_cnt[b] = bin_count[g * B + b];
    s_bin_active[b] = b < n_bins0[g];
  }
  if (tid == 0) {
    s_n_hi = n_hi0[g];
    s_n_bins = n_bins0[g];
  }
  __syncthreads();

  bool clipped = false;
  int rounds = 0, iters = 0;
  while (rounds < max_rounds) {
    ++rounds;  // this gene is active in this round

    // worst squared relative residual per active column; round 1 scores
    // against the unclipped initial estimate, later rounds the clipped one
    for (int w = tid; w < W; w += nt) {
      const int b = bid[w];
      float r = 0.f;
      if (b < B && s_bin_active[b]) {
        const float e = Eg[w];
        for (int i = 0; i < p; ++i) {
          const float f = Fg[i * W + w];
          float ke = __fmul_rn(s_K[i], e);  // no FMA into the subtraction
          if (clipped) ke = fmaxf(ke, f);
          const float z = (ke - f) / (f + 1.0f);
          r = fmaxf(r, z * z);
        }
      }
      s_res[w] = r;
    }
    __syncthreads();
    // per-bin sums in a fixed order: warp q takes bins q, q + nw, ...
    for (int b = warp; b < B; b += nw) {
      float s = 0.f;
      for (int w = lane; w < W; w += 32)
        if (bid[w] == b) s += s_res[w];
      s = warp_sum(s);
      if (lane == 0) s_ss[b] = s;
    }
    __syncthreads();
    if (tid == 0) {
      float mx = 0.f;
      int drop = 0;
      for (int b = 0; b < B; ++b) {
        const float v =
            s_bin_active[b] ? s_ss[b] / fmaxf(s_cnt[b], 1.0f) : DN_NEG;
        if (b == 0 || v > mx) {  // strict: ties go to the lower index
          mx = v;
          drop = b;
        }
      }
      int go = 0;
      if (mx != 0.0f) {  // not a perfect fit (nmf.py:286-287)
        s_bin_active[drop] = 0;
        s_n_hi -= (int)s_cnt[drop];
        s_n_bins -= 1;
        // svds ValueError below 2 columns (nmf.py:306-310): stop without
        // refreshing factors or rho
        go = s_n_hi >= 2;
      }
      s_go = go;
    }
    __syncthreads();
    if (!s_go) break;

    for (int w = tid; w < W; w += nt) {
      const int b = bid[w];
      cm[w] = (b < B && s_bin_active[b]) ? 1 : 0;
    }
    __syncthreads();

    // NMF loop on the surviving columns, u resumed from the last round
    const WideResidentSrc src{Fg, cm, Xg, Eg, W};
    float s, se;
    int ran;
    if constexpr (MODE == DN_TRIM_FAST) {
      // warm restart from the multipliers this gene's X holds (masked to
      // the surviving columns: the sweeps read only those)
      const int n_it = nmf_iter / 4 > 8 ? nmf_iter / 4 : 8;
      se = wide_core<PMAX, false>(src, WideBlockRed{}, wk, p, s, n_it,
                                  power_warm, power_warm, warm_plain, 0.f,
                                  &ran, rounds > 1);
    } else {
      se = wide_core<PMAX, MODE == DN_TRIM_TOL>(
          src, WideBlockRed{}, wk, p, s, nmf_iter, power_resume, power_warm,
          warm_plain, tol, &ran);
    }
    iters += ran;
    if (tid < PMAX) s_K[tid] = wk.u[tid] * s;
    // (the block sum's barriers make K and this round's E visible)
    const float sumE = wide_block_sum<PMAX>(wk, se);

    // all-zero fitted sample (nmf.py:315-316): keep the new K, stop
    // without refreshing rho
    float min_rs = INFINITY;
    for (int i = 0; i < p; ++i) min_rs = fminf(min_rs, __fmul_rn(s_K[i], sumE));
    if (min_rs == 0.0f) break;

    // clip up to F, recompute DI (nmf.py:318-321): warp q sums rows q,
    // q + nw, ... over the surviving columns
    for (int i = warp; i < p; i += nw) {
      const float Ki = s_K[i];
      float rf = 0.f, re = 0.f;
      for (int w = lane; w < W; w += 32) {
        if (cm[w] == 0) continue;
        const float f = Fg[i * W + w];
        rf += f;
        re += fmaxf(Ki * Eg[w], f);
      }
      rf = warp_sum(rf);
      re = warp_sum(re);
      if (lane == 0) {
        s_rf[i] = rf;
        s_re[i] = re;
      }
    }
    __syncthreads();
    if (warp == 0) {
      float mx = -INFINITY;
      for (int i = lane; i < p; i += 32) {
        const float rho = 1.0f - s_rf[i] / (s_re[i] + 1.0f);
        s_rho[i] = rho;
        mx = fmaxf(mx, rho);
      }
      mx = warp_max(mx);
      if (lane == 0) {
        const bool floor_hit =
            s_n_bins <= min_bins || s_n_hi < min_gene_len;  // nmf.py:323-324
        s_go = (!floor_hit && mx > 0.1f) ? 1 : 0;           // nmf.py:273
      }
    }
    __syncthreads();
    clipped = true;
    if (!s_go) break;
  }

  __syncthreads();
  if (tid < p) {
    K_out[g * p + tid] = s_K[tid];
    rho_out[g * p + tid] = s_rho[tid];
  }
  if (tid == 0) {
    ran_bs[g] = 1;
    rounds_out[g] = rounds;
    if (iters_out != nullptr) iters_out[g] = iters;
  }
}

// Kernel 3 on the resident core (wide_res.cuh): cl blocks a gene, as
// trim_wide_kernel otherwise; this launch runs the genes whose clusters are
// of cl blocks (counted on the columns of their initial bins; cap slots a
// block, capmax the most any launch's blocks hold), the one of clusters of
// 1 the genes that never enter the loop.
template <int PMAX, int MODE>
__global__ void __launch_bounds__(DN_WIDE_THREADS, 1)
trim_res_kernel(
    const float* __restrict__ Fm, const int* __restrict__ bin_id,
    const float* __restrict__ bin_count, const float* __restrict__ K0,
    float* E, const float* __restrict__ rho0,
    const float* __restrict__ u0, const int* __restrict__ n_hi0,
    const int* __restrict__ n_bins0, const uint8_t* __restrict__ active0,
    float* __restrict__ K_out, float* __restrict__ rho_out,
    uint8_t* __restrict__ ran_bs, int* __restrict__ rounds_out,
    int* __restrict__ iters_out, int p, int W, int B, int nmf_iter,
    int power_resume, int power_warm, int warm_plain, int max_rounds,
    int min_bins, int min_gene_len, float tol, int cap, int capmax,
    int cl) {
  __shared__ float s_K[PMAX];  // K of the last fit (zero beyond p)
  __shared__ float s_rho[PMAX];
  __shared__ float s_rf[PMAX], s_re[PMAX];  // the DI refresh's row sums
  __shared__ float s_cnt[DN_MAX_BINS];
  __shared__ float s_ss[DN_MAX_BINS];
  __shared__ int s_bin_active[DN_MAX_BINS];
  __shared__ int s_n_hi, s_n_bins, s_go;
  extern __shared__ float4 dyn4[];  // wide_res.cuh's work space

  const int rank = cl > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const size_t g = blockIdx.x / cl;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;

  // loop-never-ran result: K0, rho0, False, 0 (the same for the whole
  // cluster: all its blocks leave here)
  if (active0[g] == 0) {
    if (cl > 1) return;
    if (tid < p) {
      K_out[g * p + tid] = K0[g * p + tid];
      rho_out[g * p + tid] = rho0[g * p + tid];
    }
    if (tid == 0) {
      ran_bs[g] = 0;
      rounds_out[g] = 0;
      if (iters_out != nullptr) iters_out[g] = 0;
    }
    return;
  }

  ResWork<PMAX> wk;
  wk.init((float*)dyn4, W, cap, cl, rank);
  float* s_res = wk.res;
  const int* bid = bin_id + g * W;
  float* Eg = E + g * W;
  const float* Fg = Fm + g * p * W;
  // this block's share of E outside its active slots
  const int w_lo = (int)((long long)W * rank / cl);
  const int w_hi = (int)((long long)W * (rank + 1) / cl);
  const auto col_on = [&](int w) {
    const int b = bid[w];
    return b < B && s_bin_active[b] != 0;
  };
  {
    const int nb0 = n_bins0[g];
    if (!res_gene_runs(W, capmax, cl,
                       [&](int w) { return bid[w] < B && bid[w] < nb0; },
                       (int*)wk.ww.red))
      return;
  }

  if (tid < PMAX) {
    wk.ww.u[tid] = tid < p ? u0[g * p + tid] : 0.f;
    s_K[tid] = tid < p ? K0[g * p + tid] : 0.f;
    s_rho[tid] = tid < p ? rho0[g * p + tid] : 0.f;
  }
  for (int b = tid; b < B; b += nt) {
    s_cnt[b] = bin_count[g * B + b];
    s_bin_active[b] = b < n_bins0[g];
  }
  if (tid == 0) {
    s_n_hi = n_hi0[g];
    s_n_bins = n_bins0[g];
  }
  __syncthreads();

  bool clipped = false;
  int rounds = 0, iters = 0;
  while (rounds < max_rounds) {
    ++rounds;  // this gene is active in this round

    // worst squared relative residual per active column; round 1 scores
    // against the unclipped initial estimate, later rounds the clipped one
    for (int w = tid; w < W; w += nt) {
      const int b = bid[w];
      float r = 0.f;
      if (b < B && s_bin_active[b]) {
        const float e = Eg[w];
        for (int i = 0; i < p; ++i) {
          const float f = Fg[i * W + w];
          float ke = __fmul_rn(s_K[i], e);  // no FMA into the subtraction
          if (clipped) ke = fmaxf(ke, f);
          const float z = (ke - f) / (f + 1.0f);
          r = fmaxf(r, z * z);
        }
      }
      s_res[w] = r;
    }
    __syncthreads();
    // per-bin sums in a fixed order: warp q takes bins q, q + nw, ...
    for (int b = warp; b < B; b += nw) {
      float s = 0.f;
      for (int w = lane; w < W; w += 32)
        if (bid[w] == b) s += s_res[w];
      s = warp_sum(s);
      if (lane == 0) s_ss[b] = s;
    }
    __syncthreads();
    if (tid == 0) {
      float mx = 0.f;
      int drop = 0;
      for (int b = 0; b < B; ++b) {
        const float v =
            s_bin_active[b] ? s_ss[b] / fmaxf(s_cnt[b], 1.0f) : DN_NEG;
        if (b == 0 || v > mx) {  // strict: ties go to the lower index
          mx = v;
          drop = b;
        }
      }
      int go = 0;
      if (mx != 0.0f) {  // not a perfect fit (nmf.py:286-287)
        s_bin_active[drop] = 0;
        s_n_hi -= (int)s_cnt[drop];
        s_n_bins -= 1;
        // svds ValueError below 2 columns (nmf.py:306-310): stop without
        // refreshing factors or rho
        go = s_n_hi >= 2;
      }
      s_go = go;
    }
    __syncthreads();
    if (!s_go) break;

    // the first round's surviving columns become the block's slots, held
    // for every later round (whose columns are among them)
    if (rounds == 1) res_deal<PMAX>(wk, p, W, col_on, bid);
    const auto slot_on = [&](int j) { return s_bin_active[wk.sbin[j]] != 0; };

    // NMF loop on the surviving columns, u resumed from the last round
    float s, se;
    int ran;
    if constexpr (MODE == DN_TRIM_FAST) {
      // warm restart from the multipliers this gene's X holds (masked to
      // the surviving columns)
      const int n_it = nmf_iter / 4 > 8 ? nmf_iter / 4 : 8;
      se = res_core<PMAX, false>(wk, Fg, Eg, p, W, slot_on, s, n_it,
                                 power_warm, power_warm, warm_plain, 0.f,
                                 &ran, rounds > 1);
    } else {
      se = res_core<PMAX, MODE == DN_TRIM_TOL>(
          wk, Fg, Eg, p, W, slot_on, s, nmf_iter, power_resume, power_warm,
          warm_plain, tol, &ran);
    }
    for (int w = w_lo + tid; w < w_hi; w += nt)
      if (!col_on(w)) Eg[w] = 0.f;
    iters += ran;
    if (tid < PMAX) s_K[tid] = wk.ww.u[tid] * s;
    // (the block sum's barriers make K and the block's E visible; the
    // cluster sum's barriers the cluster's E)
    __threadfence();
    const float sumE = res_cluster_sum<PMAX>(wk, wide_block_sum<PMAX>(wk.ww, se));

    // all-zero fitted sample (nmf.py:315-316): keep the new K, stop
    // without refreshing rho
    float min_rs = INFINITY;
    for (int i = 0; i < p; ++i) min_rs = fminf(min_rs, __fmul_rn(s_K[i], sumE));
    if (min_rs == 0.0f) break;

    // clip up to F, recompute DI (nmf.py:318-321): warp q sums rows q,
    // q + nw, ... over the surviving columns
    for (int i = warp; i < p; i += nw) {
      const float Ki = s_K[i];
      float rf = 0.f, re = 0.f;
      for (int w = lane; w < W; w += 32) {
        if (!col_on(w)) continue;
        const float f = Fg[i * W + w];
        rf += f;
        re += fmaxf(Ki * Eg[w], f);
      }
      rf = warp_sum(rf);
      re = warp_sum(re);
      if (lane == 0) {
        s_rf[i] = rf;
        s_re[i] = re;
      }
    }
    __syncthreads();
    if (warp == 0) {
      float mx = -INFINITY;
      for (int i = lane; i < p; i += 32) {
        const float rho = 1.0f - s_rf[i] / (s_re[i] + 1.0f);
        s_rho[i] = rho;
        mx = fmaxf(mx, rho);
      }
      mx = warp_max(mx);
      if (lane == 0) {
        const bool floor_hit =
            s_n_bins <= min_bins || s_n_hi < min_gene_len;  // nmf.py:323-324
        s_go = (!floor_hit && mx > 0.1f) ? 1 : 0;           // nmf.py:273
      }
    }
    __syncthreads();
    clipped = true;
    if (!s_go) break;
  }

  // no block leaves while another of its cluster may read its shared memory
  // (the last cluster sum ends with a cluster barrier)
  __syncthreads();
  if (rank == 0) {
    if (tid < p) {
      K_out[g * p + tid] = s_K[tid];
      rho_out[g * p + tid] = s_rho[tid];
    }
    if (tid == 0) {
      ran_bs[g] = 1;
      rounds_out[g] = rounds;
      if (iters_out != nullptr) iters_out[g] = iters;
    }
  }
}

template <int MODE>
int launch_trim_wide(const TrimArgs& a) {
  if (a.threads != DN_WIDE_THREADS || a.B > DN_MAX_BINS ||
      a.p < DN_WIDE_MIN_P || a.p > DN_WIDE_MAX_P)
    return (int)cudaErrorInvalidValue;
  if (a.G == 0) return 0;
#define CALL(PM)                                                              \
  do {                                                                        \
    if constexpr (dn_res_on<PM>()) {                                          \
      const int e = dn_res_launch<PM>(                                        \
          trim_res_kernel<PM, MODE>, a.G, a.W, a.stream, a.Fm, a.bin_id,      \
          a.bin_count, a.K0, a.E, a.rho0, a.u0, a.n_hi, a.n_bins, a.active0,  \
          a.K, a.rho, a.ran_bs, a.rounds_active, a.iters, a.p, a.W, a.B,      \
          a.nmf_iter, a.power_resume, a.power_warm, a.warm_plain,             \
          a.max_rounds, a.min_bins, a.min_gene_len, a.tol);                   \
      if (e != 0) return e;                                                   \
    } else {                                                                  \
      const size_t dyn =                                                      \
          sizeof(float) * ((size_t)wide_sync_floats<PM>() + a.W);             \
      cudaError_t e = cudaFuncSetAttribute(                                   \
          trim_wide_kernel<PM, MODE>,                                         \
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);             \
      if (e != cudaSuccess) return (int)e;                                    \
      trim_wide_kernel<PM, MODE><<<a.G, DN_WIDE_THREADS, dyn, a.stream>>>(    \
          a.Fm, a.bin_id, a.bin_count, a.K0, a.E, a.rho0, a.u0, a.n_hi,       \
          a.n_bins, a.active0, a.X, a.colmask, a.K, a.rho, a.ran_bs,          \
          a.rounds_active, a.iters, a.p, a.W, a.B, a.nmf_iter,                \
          a.power_resume, a.power_warm, a.warm_plain, a.max_rounds,           \
          a.min_bins, a.min_gene_len, a.tol);                                 \
    }                                                                         \
  } while (0)
  DN_DISPATCH_WIDE_P(a.p, CALL);
#undef CALL
  return (int)cudaGetLastError();
}
