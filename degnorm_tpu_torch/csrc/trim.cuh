// Kernel 3: the whole baseline-selection trim loop, one thread block per gene.
// The kernel and its launch; the C entry point is trim.cu, the default
// instances are compiled there, the trim_fast ones in trim_fast.cu and the
// nmf_tol ones in trim_tol.cu, side by side.
//
// Replaces the TPU kernel degnorm_tpu/ops/pallas_trim.py::trim_loop_pallas
// (_trim_kernel).  Per gene, for up to max_rounds rounds while the gene is
// active: worst squared relative residual per column, mean per rank bin,
// drop the first arg-max bin, update n_hi / n_bins, rerun the Lagrangian
// NMF loop (common.cuh::nmf_core) on the surviving columns with u resumed
// from the previous round, zero-row check, clipped DI refresh, exit flags.
// Semantics follow the lax.while_loop of degnorm_tpu/core/baseline.py.
//
// The TPU kernel iterates a whole gene block until every gene in it is
// inactive; blocks here are single genes, so the block loops while its OWN
// gene is active.  `active` only ever switches off, so the per-gene round
// count equals the TPU's shared counter for every round the gene is active.
// Counters and flags are ints and bools (the TPU kernel carries f32 masks).
// The trim state's E is dead after the loop, so no E is returned; the E
// buffer is scratch that carries each round's column factor to the next
// round's residuals.
//
// What bounds it on this card.  By count it is float32 operations (a round
// is a full NMF loop plus two light passes, and a gene costs rounds_active
// of them); in practice the latency of a sweep at the occupancy its
// registers allow (common.cuh).  The design gives a gene few threads (one per
// 16 columns, ops/cuda_nmf.py), so that what a sweep costs besides its
// columns is paid by few warps, keeps every instance within the registers of
// its launch bound without a spill at p <= 16, and takes the sweep of
// common.cuh: one barrier, a butterfly reduction, the power step on every
// warp, no mask loads after the first pass.  X stays in a global scratch:
// keeping it, and the coverage, in the block's shared memory was built and
// measured slower at every block size (fewer blocks an SM).
//
// The opt-in branches of the TPU kernel are instances (MODE):
//   * DN_TRIM_FAST (EngineConfig.trim_fast, pallas_trim.py:85-92, :135-176):
//     every round, the first included, runs max(nmf_iter / 4, 8) Lagrangian
//     steps of size 1/sqrt(that), its cold refit the squared scheme at
//     power_warm from the carried u, and its multipliers carried over from
//     the previous round in the gene's X scratch (round 1 starts from
//     X = A0, lambda = 0): the cold sweep of rounds after the first reads
//     the X the gene holds (common.cuh::nmf_core's from_x).  X stays in
//     global memory between rounds, where it already lived;
//   * DN_TRIM_TOL (EngineConfig.nmf_tol > 0, pallas_trim.py:177-186): each
//     round's loop is nmf_core's ADAPT instance, a frozen gene leaving its
//     round's loop early.
// `iters` (where given) receives the Lagrangian iterations each gene ran
// over all its rounds.
#pragma once
#include "common.cuh"

#define DN_TRIM_DEFAULT 0
#define DN_TRIM_FAST 1
#define DN_TRIM_TOL 2

#define DN_MAX_BINS 64
#define DN_NEG -1e30f

template <int PMAX, bool FULL, int MODE>
__global__ void __launch_bounds__(32 * dn_max_warps<PMAX>(), 1)
trim_loop_kernel(
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
  __shared__ BlockRed<PMAX> red;
  // the warps' shares of the sum of E, then of the DI row sums
  __shared__ float s_part[dn_max_warps<PMAX>() * 2 * PMAX];
  __shared__ float s_K[PMAX];  // K of the last fit (zero beyond p)
  __shared__ float s_rho[PMAX];
  __shared__ float s_cnt[DN_MAX_BINS];
  __shared__ float s_ss[DN_MAX_BINS];
  __shared__ int s_bin_active[DN_MAX_BINS];
  __shared__ int s_n_hi, s_n_bins, s_go;
  // (W) per-column residual scores, then the Gram tiles (p >= 16)
  extern __shared__ float dyn[];

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

  float* s_res = dyn;
  float* tiles = s_res + W;
  const int* bid = bin_id + g * W;
  float* Eg = E + g * W;
  uint8_t* cm = colmask + g * W;
  const float* Fg = Fm + g * p * W;
  float* Xg = Xscratch + g * p * W;

  // lane i of every warp carries u_i (zero beyond p)
  float u_lane = lane < p ? u0[g * p + lane] : 0.f;
  if (tid < PMAX) {
    s_K[tid] = tid < p ? K0[g * p + tid] : 0.f;
    s_rho[tid] = tid < p ? rho0[g * p + tid] : 0.f;
  }
  // a block may have fewer threads than the gene has bins (32 against 64)
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
  const float* K = s_K;
  while (rounds < max_rounds) {
    ++rounds;  // this gene is active in this round

    // worst squared relative residual per active column; round 1 scores
    // against the unclipped initial estimate, later rounds the clipped one
    for (int w = tid; w < W; w += nt) {
      const int b = bid[w];
      float r = 0.f;
      if (b < B && s_bin_active[b]) {
        const float e = Eg[w];
#pragma unroll
        for (int i = 0; i < PMAX; ++i) {
          if (DN_ROW(i)) {
            const float f = Fg[i * W + w];
            float ke = __fmul_rn(K[i], e);  // no FMA into the subtraction
            if (clipped) ke = fmaxf(ke, f);
            const float z = (ke - f) / (f + 1.0f);
            r = fmaxf(r, z * z);
          }
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
    ResidentSrc<PMAX, FULL> src{Fg, cm, Xg, Eg, p, W};
    float s, se;
    int ran;
    if constexpr (MODE == DN_TRIM_FAST) {
      // warm restart from the multipliers this gene's X holds (masked to
      // the surviving columns: the sweeps read only those)
      const int n_it = nmf_iter / 4 > 8 ? nmf_iter / 4 : 8;
      se = nmf_core<PMAX>(src, red, tiles, u_lane, s, n_it, power_warm,
                          power_warm, warm_plain, 0.f, &ran, rounds > 1);
    } else {
      se = nmf_core<PMAX, BlockGeo, MODE == DN_TRIM_TOL>(
          src, red, tiles, u_lane, s, nmf_iter, power_resume, power_warm,
          warm_plain, tol, &ran);
    }
    iters += ran;
    if (tid < PMAX) s_K[tid] = u_lane * s;
    {
      const float ws = warp_sum(se);
      if (lane == 0) s_part[warp] = ws;
    }
    __syncthreads();  // also: K and E of this round are visible to all
    float sumE = 0.f;
    for (int w = 0; w < nw; ++w) sumE += s_part[w];

    // all-zero fitted sample (nmf.py:315-316): keep the new K, stop
    // without refreshing rho
    float min_rs = INFINITY;
#pragma unroll
    for (int i = 0; i < PMAX; ++i)
      if (DN_ROW(i)) min_rs = fminf(min_rs, __fmul_rn(K[i], sumE));
    if (min_rs == 0.0f) break;
    __syncthreads();  // s_part is read by all before it is written again

    // clip up to F, recompute DI (nmf.py:318-321)
    {
      float acc[2 * PMAX];
#pragma unroll
      for (int i = 0; i < 2 * PMAX; ++i) acc[i] = 0.f;
      for (int w = tid; w < W; w += nt) {
        if (cm[w] == 0) continue;
        const float e = Eg[w];
#pragma unroll
        for (int i = 0; i < PMAX; ++i) {
          if (DN_ROW(i)) {
            const float f = Fg[i * W + w];
            acc[i] += f;
            acc[PMAX + i] += fmaxf(K[i] * e, f);
          }
        }
      }
      warp_reduce_store<2 * PMAX>(acc, s_part + warp * 2 * PMAX, lane);
    }
    __syncthreads();
    if (warp == 0) {
      float rho = -INFINITY;
      if (lane < p) {
        float rf = 0.f, re = 0.f;
        for (int w = 0; w < nw; ++w) {
          rf += s_part[w * 2 * PMAX + lane];
          re += s_part[w * 2 * PMAX + PMAX + lane];
        }
        rho = 1.0f - rf / (re + 1.0f);
        s_rho[lane] = rho;
      }
      const float mx = warp_max(rho);
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

// Arguments of the launch.  X: (G, p, W) float32 scratch; iters: (G) int32
// or null.
struct TrimArgs {
  const float* Fm;
  const int* bin_id;
  const float* bin_count;
  const float* K0;
  float* E;
  const float* rho0;
  const float* u0;
  const int* n_hi;
  const int* n_bins;
  const uint8_t* active0;
  float* X;
  uint8_t* colmask;
  float* K;
  float* rho;
  uint8_t* ran_bs;
  int* rounds_active;
  int* iters;
  int G, p, W, B, nmf_iter, power_resume, power_warm, warm_plain, max_rounds,
      min_bins, min_gene_len;
  float tol;
  int threads;
  cudaStream_t stream;
  float* ws = nullptr;  // p > 128: the panel instance's workspace and
  int ws_slots = 0;     // its slots (trim.cu's dn_trim_loop says what)
};

template <int MODE>
int launch_trim(const TrimArgs& a) {
  if (a.threads % 32 != 0 || a.threads < 32 || a.threads > 512 ||
      a.B > DN_MAX_BINS)
    return (int)cudaErrorInvalidValue;
#define CALL(PM, FULL)                                                        \
  do {                                                                        \
    if (a.threads > 32 * dn_max_warps<PM>())                                  \
      return (int)cudaErrorInvalidValue;                                      \
    const size_t dyn =                                                        \
        sizeof(float) * ((size_t)a.W + gram_tile_floats<PM>(a.threads / 32)); \
    cudaError_t e = cudaFuncSetAttribute(                                     \
        trim_loop_kernel<PM, FULL, MODE>,                                     \
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);               \
    if (e != cudaSuccess) return (int)e;                                      \
    trim_loop_kernel<PM, FULL, MODE><<<a.G, a.threads, dyn, a.stream>>>(      \
        a.Fm, a.bin_id, a.bin_count, a.K0, a.E, a.rho0, a.u0, a.n_hi,         \
        a.n_bins, a.active0, a.X, a.colmask, a.K, a.rho, a.ran_bs,            \
        a.rounds_active, a.iters, a.p, a.W, a.B, a.nmf_iter, a.power_resume,  \
        a.power_warm, a.warm_plain, a.max_rounds, a.min_bins,                 \
        a.min_gene_len, a.tol);                                               \
  } while (0)
  DN_DISPATCH_P(a.p, CALL);
#undef CALL
  return (int)cudaGetLastError();
}

// the trim_fast and nmf_tol instances (trim_fast.cu, trim_tol.cu)
int dn_trim_fast(const TrimArgs& a);
int dn_trim_tol(const TrimArgs& a);
// the instances for 33 <= p <= 128 (trim_wide.cuh: trim_wide.cu,
// trim_wide_fast.cu, trim_wide_tol.cu)
int dn_trim_wide(const TrimArgs& a);
int dn_trim_wide_fast(const TrimArgs& a);
int dn_trim_wide_tol(const TrimArgs& a);
// the instances for p > 128 (trim_panel.cu: panel.cuh's core), every mode
int dn_trim_panel(const TrimArgs& a, int mode);


