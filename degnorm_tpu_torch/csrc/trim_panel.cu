// Kernel 3 for p > 128 samples: the whole baseline-selection trim loop, each
// round's NMF loop on panel.cuh's row panels; the instances of every mode
// in this one translation unit.  The C entry point stays trim.cu's
// dn_trim_loop, which hands p > 128 here.
//
// Replaces, for studies of more than 128 samples, the TPU kernel
// degnorm_tpu/ops/pallas_trim.py::trim_loop_pallas (_trim_kernel), as
// trim_wide.cuh does for 33 <= p <= 128, with the same rounds, flags,
// counters, results and opt-in branches (MODE: DN_TRIM_FAST's warm-restart
// rounds from the X the gene holds, DN_TRIM_TOL's adaptive freeze); its
// round is trim_wide.cuh's.  Bound on this card: float32 operations (a
// round is a full NMF loop, see panel.cuh).  Two layouts:
//   * p <= DN_PCL_MAX_P (trim_panel_kernel): a CLUSTER of blocks a gene,
//     its panel pairs over the blocks (pcl_core, a round's loop out of line:
//     trim_round_nmf), clusters working through the genes;
//     every block runs the rounds' scoring, bin choice and DI refresh on
//     the same numbers (a few W x p passes a round beside a 50-sweep NMF
//     loop), so the cluster takes the same branches, and block 0 writes
//     the column mask, E and the results; K, rho and the row sums in
//     shared memory;
//   * above (trim_panel_block_kernel): one block a gene at a time on
//     panel_core, with K, rho and the row sums in the block's slot of the
//     workspace.
#include "panel.cuh"
#include "trim.cuh"

template <int MODE>
__global__ void __launch_bounds__(DN_WIDE_THREADS, 1)
trim_panel_block_kernel(
    const float* __restrict__ Fm, const int* __restrict__ bin_id,
    const float* __restrict__ bin_count, const float* __restrict__ K0,
    float* E, const float* __restrict__ rho0,
    const float* __restrict__ u0, const int* __restrict__ n_hi0,
    const int* __restrict__ n_bins0, const uint8_t* __restrict__ active0,
    float* Xscratch, uint8_t* colmask,
    float* __restrict__ K_out, float* __restrict__ rho_out,
    uint8_t* __restrict__ ran_bs, int* __restrict__ rounds_out,
    int* __restrict__ iters_out, int G, int p, int W, int B, int nmf_iter,
    int power_resume, int power_warm, int warm_plain, int max_rounds,
    int min_bins, int min_gene_len, float tol, float* ws) {
  __shared__ float s_cnt[DN_MAX_BINS];
  __shared__ float s_ss[DN_MAX_BINS];
  __shared__ int s_bin_active[DN_MAX_BINS];
  __shared__ int s_n_hi, s_n_bins, s_go;
  // the core's work space, then the (W) per-column residual scores
  extern __shared__ float4 dyn4[];

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;

  // the p-vectors in the block's workspace: K of the last fit and rho (zero
  // beyond p), the DI refresh's row sums
  PanelWork wk;
  wk.init((float*)dyn4, ws + blockIdx.x * dn_panel_ws_floats(p), p);
  float* s_K = wk.x[0];
  float* s_rho = wk.x[1];
  float* s_rf = wk.x[2];
  float* s_re = wk.x[3];
  float* s_res = (float*)dyn4 + panel_smem_floats();
  const int nv = wk.np;

  for (size_t g = blockIdx.x; g < (size_t)G; g += gridDim.x) {
    // loop-never-ran result: K0, rho0, False, 0
    if (active0[g] == 0) {
      for (int i = tid; i < p; i += nt) {
        K_out[g * p + i] = K0[g * p + i];
        rho_out[g * p + i] = rho0[g * p + i];
      }
      if (tid == 0) {
        ran_bs[g] = 0;
        rounds_out[g] = 0;
        if (iters_out != nullptr) iters_out[g] = 0;
      }
      continue;
    }

    const int* bid = bin_id + g * W;
    float* Eg = E + g * W;
    uint8_t* cm = colmask + g * W;
    const float* Fg = Fm + g * p * W;
    float* Xg = Xscratch + g * p * W;

    for (int i = tid; i < nv; i += nt) {
      wk.u[i] = i < p ? u0[g * p + i] : 0.f;
      s_K[i] = i < p ? K0[g * p + i] : 0.f;
      s_rho[i] = i < p ? rho0[g * p + i] : 0.f;
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
      // trim_fast: a warm restart from the multipliers this gene's X holds
      // (masked to the surviving columns: the sweeps read only those)
      constexpr bool FAST = MODE == DN_TRIM_FAST, ADAPT = MODE == DN_TRIM_TOL;
      const int n_it = FAST ? (nmf_iter / 4 > 8 ? nmf_iter / 4 : 8) : nmf_iter;
      const int n_cold = FAST ? power_warm : power_resume;
      const bool from_x = FAST && rounds > 1;
      float s, se, sumE;
      int ran;
      se = panel_core<ADAPT>(src, wk, s, n_it, n_cold, power_warm,
                             warm_plain, tol, &ran, from_x);
      iters += ran;
      for (int i = tid; i < nv; i += nt) s_K[i] = wk.u[i] * s;
      // (the block sum's barriers make K and this round's E visible)
      sumE = panel_sum(wk.red, se);

      // all-zero fitted sample (nmf.py:315-316): keep the new K, stop
      // without refreshing rho
      float min_rs = INFINITY;
      for (int i = 0; i < p; ++i)
        min_rs = fminf(min_rs, __fmul_rn(s_K[i], sumE));
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
    for (int i = tid; i < p; i += nt) {
      K_out[g * p + i] = s_K[i];
      rho_out[g * p + i] = s_rho[i];
    }
    if (tid == 0) {
      ran_bs[g] = 1;
      rounds_out[g] = rounds;
      if (iters_out != nullptr) iters_out[g] = iters;
    }
    __syncthreads();  // the gene's state is read before the next one's
  }
}

// A round's NMF loop on the cluster layout (pcl_core, the blocks' several
// pairs included), compiled out of line with its own registers (inline,
// beside the rounds' state, the kernel's registers spilled), its arguments
// values: this thread's share of sum_w E[w], s, the iterations run and the
// work space's count of v's tiles.
struct PclRound {
  float se, s;
  int ran, nact;
};
template <bool ADAPT>
static __device__ __noinline__ PclRound trim_round_nmf(
    WideResidentSrc src, PclWork<float> w, int n_it, int n_cold,
    int power_warm, int warm_plain, float tol, bool from_x) {
  PclRound r;
  r.se = pcl_core<ADAPT>(src, w, r.s, n_it, n_cold, power_warm, warm_plain,
                         tol, &r.ran, from_x);
  r.nact = w.nact;
  return r;
}

template <int MODE>
__global__ void __launch_bounds__(DN_WIDE_THREADS, 1)
trim_panel_kernel(
    const float* __restrict__ Fm, const int* __restrict__ bin_id,
    const float* __restrict__ bin_count, const float* __restrict__ K0,
    float* E, const float* __restrict__ rho0,
    const float* __restrict__ u0, const int* __restrict__ n_hi0,
    const int* __restrict__ n_bins0, const uint8_t* __restrict__ active0,
    float* Xscratch, uint8_t* colmask,
    float* __restrict__ K_out, float* __restrict__ rho_out,
    uint8_t* __restrict__ ran_bs, int* __restrict__ rounds_out,
    int* __restrict__ iters_out, int G, int p, int W, int B, int nmf_iter,
    int power_resume, int power_warm, int warm_plain, int max_rounds,
    int min_bins, int min_gene_len, float tol, float* ws) {
  __shared__ float s_cnt[DN_MAX_BINS];
  __shared__ float s_ss[DN_MAX_BINS];
  __shared__ int s_bin_active[DN_MAX_BINS];
  __shared__ int s_n_hi, s_n_bins, s_go;
  // the core's work space, then the (W) per-column residual scores
  extern __shared__ float4 dyn4[];

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();

  // K of the last fit and rho (zero beyond p) in the kernel's p-vectors,
  // the DI refresh's row sums in the core's matvec vectors (free between
  // rounds)
  PclWork<float> wk;
  // (the cluster's slot of the workspace where a block holds several pairs)
  wk.init((float*)dyn4, p, rank,
          ws != nullptr ? ws + (blockIdx.x / C) * dn_pcl_ws_floats(p)
                        : nullptr);
  float* s_K = wk.x(0);
  float* s_rho = wk.x(1);
  float* s_rf = wk.va();
  float* s_re = wk.vb();
  float* s_res = (float*)dyn4 + dn_pcl_smem_floats(p);
  const int nv = wk.np;

  // every block of a cluster runs its gene's rounds on the same numbers;
  // block 0 writes what leaves the cluster (the column mask, E, the results)
  for (size_t g = blockIdx.x / C; g < (size_t)G; g += gridDim.x / C) {
    // loop-never-ran result: K0, rho0, False, 0
    if (active0[g] == 0) {
      if (rank == 0) {
        for (int i = tid; i < p; i += nt) {
          K_out[g * p + i] = K0[g * p + i];
          rho_out[g * p + i] = rho0[g * p + i];
        }
        if (tid == 0) {
          ran_bs[g] = 0;
          rounds_out[g] = 0;
          if (iters_out != nullptr) iters_out[g] = 0;
        }
      }
      continue;
    }

    const int* bid = bin_id + g * W;
    float* Eg = E + g * W;
    uint8_t* cm = colmask + g * W;
    const float* Fg = Fm + g * p * W;
    wk.X = Xscratch + g * W * wk.ldx;  // X column by column

    for (int i = tid; i < nv; i += nt) {
      wk.u()[i] = i < p ? u0[g * p + i] : 0.f;
      s_K[i] = i < p ? K0[g * p + i] : 0.f;
      s_rho[i] = i < p ? rho0[g * p + i] : 0.f;
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

      // every block is done with the last round's mask before block 0
      // rewrites it (the core's first cluster barrier makes it visible)
      cluster.sync();
      if (rank == 0)
        for (int w = tid; w < W; w += nt) {
          const int b = bid[w];
          cm[w] = (b < B && s_bin_active[b]) ? 1 : 0;
        }
      __syncthreads();

      // NMF loop on the surviving columns, u resumed from the last round
      const WideResidentSrc src{Fg, cm, nullptr, Eg, W};
      // trim_fast: a warm restart from the multipliers this gene's X holds
      // (masked to the surviving columns: the sweeps read only those)
      constexpr bool FAST = MODE == DN_TRIM_FAST, ADAPT = MODE == DN_TRIM_TOL;
      const int n_it = FAST ? (nmf_iter / 4 > 8 ? nmf_iter / 4 : 8) : nmf_iter;
      const int n_cold = FAST ? power_warm : power_resume;
      const bool from_x = FAST && rounds > 1;
      const PclRound r = trim_round_nmf<ADAPT>(
          src, wk, n_it, n_cold, power_warm, warm_plain, tol, from_x);
      wk.nact = r.nact;
      iters += r.ran;
      for (int i = tid; i < nv; i += nt) s_K[i] = wk.u()[i] * r.s;
      // (the block sum's barriers make K and this round's E visible)
      const float sumE = panel_sum(wk.red(), r.se);

      // all-zero fitted sample (nmf.py:315-316): keep the new K, stop
      // without refreshing rho
      float min_rs = INFINITY;
      for (int i = 0; i < p; ++i)
        min_rs = fminf(min_rs, __fmul_rn(s_K[i], sumE));
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
    if (rank == 0) {
      for (int i = tid; i < p; i += nt) {
        K_out[g * p + i] = s_K[i];
        rho_out[g * p + i] = s_rho[i];
      }
      if (tid == 0) {
        ran_bs[g] = 1;
        rounds_out[g] = rounds;
        if (iters_out != nullptr) iters_out[g] = iters;
      }
    }
    __syncthreads();  // the gene's state is read before the next one's
  }
}

int dn_trim_panel(const TrimArgs& a, int mode) {
  if (a.threads != DN_WIDE_THREADS || a.B > DN_MAX_BINS ||
      a.p < DN_PANEL_MIN_P)
    return (int)cudaErrorInvalidValue;
  if (dn_pcl_on(a.p, DN_PCL_LOOP)) {
    // blocks of several pairs keep them in the workspace
    if (dn_pcl_held(a.p) > 1 && a.ws == nullptr)
      return (int)cudaErrorInvalidValue;
#define DN_TRIM_PCL_ARGS                                                      \
  DN_PCL_LOOP,                                                                \
  a.G, a.p, a.ws_slots, (size_t)dn_pcl_smem_floats(a.p) + a.W, a.stream,      \
      a.Fm, a.bin_id, a.bin_count, a.K0, a.E, a.rho0, a.u0, a.n_hi, a.n_bins, \
      a.active0, a.X, a.colmask, a.K, a.rho, a.ran_bs, a.rounds_active,       \
      a.iters, a.G, a.p, a.W, a.B, a.nmf_iter, a.power_resume, a.power_warm,  \
      a.warm_plain, a.max_rounds, a.min_bins, a.min_gene_len, a.tol,          \
      dn_pcl_held(a.p) > 1 ? a.ws : nullptr
    if (mode == DN_TRIM_FAST)
      return launch_pcl(trim_panel_kernel<DN_TRIM_FAST>, DN_TRIM_PCL_ARGS);
    if (mode == DN_TRIM_TOL)
      return launch_pcl(trim_panel_kernel<DN_TRIM_TOL>, DN_TRIM_PCL_ARGS);
    return launch_pcl(trim_panel_kernel<DN_TRIM_DEFAULT>, DN_TRIM_PCL_ARGS);
#undef DN_TRIM_PCL_ARGS
  }
  if (a.ws == nullptr) return (int)cudaErrorInvalidValue;
#define DN_TRIM_PANEL_ARGS                                                    \
  a.G, a.ws_slots, (size_t)a.W, a.stream, a.Fm, a.bin_id, a.bin_count, a.K0,  \
      a.E, a.rho0, a.u0, a.n_hi, a.n_bins, a.active0, a.X, a.colmask, a.K,    \
      a.rho, a.ran_bs, a.rounds_active, a.iters, a.G, a.p, a.W, a.B,          \
      a.nmf_iter, a.power_resume, a.power_warm, a.warm_plain, a.max_rounds,   \
      a.min_bins, a.min_gene_len, a.tol, a.ws
  if (mode == DN_TRIM_FAST)
    return launch_panel(trim_panel_block_kernel<DN_TRIM_FAST>,
                        DN_TRIM_PANEL_ARGS);
  if (mode == DN_TRIM_TOL)
    return launch_panel(trim_panel_block_kernel<DN_TRIM_TOL>,
                        DN_TRIM_PANEL_ARGS);
  return launch_panel(trim_panel_block_kernel<DN_TRIM_DEFAULT>,
                      DN_TRIM_PANEL_ARGS);
#undef DN_TRIM_PANEL_ARGS
}
