// Kernel 3: the whole baseline-selection trim loop, one thread block per gene.
//
// Replaces the TPU kernel degnorm_tpu/ops/pallas_trim.py::trim_loop_pallas
// (_trim_kernel).  Per gene, for up to max_rounds rounds while the gene is
// active: worst squared relative residual per column, mean per rank bin,
// drop the first arg-max bin, update n_hi / n_bins, rerun the Lagrangian
// NMF loop (common.cuh::nmf_loop) on the surviving columns with u resumed
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
// Bound on this card: float32 operations — each round is a full NMF loop
// (see nmf.cu) plus two light passes; the coverage of a gene is read from
// device memory once and stays in L2 for the later rounds.  Work depends on
// the data: a gene costs rounds_active NMF loops over its surviving columns.
#include "common.cuh"

#define DN_MAX_BINS 64
#define DN_NEG -1e30f

template <int PMAX>
__global__ void trim_loop_kernel(
    const float* __restrict__ Fm, const int* __restrict__ bin_id,
    const float* __restrict__ bin_count, const float* __restrict__ K0,
    float* E, const float* __restrict__ rho0,
    const float* __restrict__ u0, const int* __restrict__ n_hi0,
    const int* __restrict__ n_bins0, const uint8_t* __restrict__ active0,
    float* X, uint8_t* colmask,
    float* __restrict__ K_out, float* __restrict__ rho_out,
    uint8_t* __restrict__ ran_bs, int* __restrict__ rounds_out, int p, int W,
    int B, int nmf_iter, int power_resume, int power_warm, int warm_plain,
    int max_rounds, int min_bins, int min_gene_len) {
  __shared__ NmfSmem<PMAX> sm;
  __shared__ float s_rho[PMAX];
  __shared__ float s_cnt[DN_MAX_BINS];
  __shared__ float s_ss[DN_MAX_BINS];
  __shared__ int s_bin_active[DN_MAX_BINS];
  __shared__ int s_n_hi, s_n_bins, s_go;
  extern __shared__ float s_res[];  // (W) per-column residual scores

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
    }
    return;
  }

  const float* Fg = Fm + g * p * W;
  const int* bid = bin_id + g * W;
  float* Eg = E + g * W;
  float* Xg = X + g * p * W;
  uint8_t* cm = colmask + g * W;

  if (tid < PMAX) {
    sm.K[tid] = tid < p ? K0[g * p + tid] : 0.f;
    sm.u[tid] = tid < p ? u0[g * p + tid] : 0.f;
    s_rho[tid] = tid < p ? rho0[g * p + tid] : 0.f;
  }
  if (tid < B) {
    s_cnt[tid] = bin_count[g * B + tid];
    s_bin_active[tid] = tid < n_bins0[g];
  }
  if (tid == 0) {
    s_n_hi = n_hi0[g];
    s_n_bins = n_bins0[g];
  }
  __syncthreads();

  bool clipped = false;
  int rounds = 0;
  while (rounds < max_rounds) {
    ++rounds;  // this gene is active in this round

    // worst squared relative residual per active column; round 1 scores
    // against the unclipped initial estimate, later rounds the clipped one
    {
      float K[PMAX];
#pragma unroll
      for (int i = 0; i < PMAX; ++i) K[i] = sm.K[i];
      for (int w = tid; w < W; w += nt) {
        const int b = bid[w];
        float r = 0.f;
        if (b < B && s_bin_active[b]) {
          const float e = Eg[w];
#pragma unroll
          for (int i = 0; i < PMAX; ++i) {
            if (i < p) {
              const float f = Fg[(size_t)i * W + w];
              float ke = __fmul_rn(K[i], e);  // no FMA into the subtraction
              if (clipped) ke = fmaxf(ke, f);
              const float z = (ke - f) / (f + 1.0f);
              r = fmaxf(r, z * z);
            }
          }
        }
        s_res[w] = r;
      }
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

    // full NMF loop on the surviving columns, u resumed from sm.u
    nmf_loop<PMAX>(sm, Fg, cm, Xg, Eg, p, W, nmf_iter, power_resume,
                   power_warm, warm_plain);

    // all-zero fitted sample (nmf.py:315-316): keep the new K, stop
    // without refreshing rho
    float min_rs = INFINITY;
    for (int i = 0; i < p; ++i)
      min_rs = fminf(min_rs, __fmul_rn(sm.K[i], sm.sumE));
    if (min_rs == 0.0f) break;

    // clip up to F, recompute DI (nmf.py:318-321)
    float acc[2 * PMAX];
    {
      float K[PMAX];
#pragma unroll
      for (int i = 0; i < PMAX; ++i) {
        K[i] = sm.K[i];
        acc[i] = 0.f;
        acc[PMAX + i] = 0.f;
      }
      for (int w = tid; w < W; w += nt) {
        if (cm[w] == 0) continue;
        const float e = Eg[w];
#pragma unroll
        for (int i = 0; i < PMAX; ++i) {
          if (i < p) {
            const float f = Fg[(size_t)i * W + w];
            acc[i] += f;
            acc[PMAX + i] += fmaxf(K[i] * e, f);
          }
        }
      }
    }
    block_reduce<2 * PMAX>(acc, sm.part, sm.red);
    if (warp == 0) {
      float rho = -INFINITY;
      if (lane < p) {
        rho = 1.0f - sm.red[lane] / (sm.red[PMAX + lane] + 1.0f);
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

  if (tid < p) {
    K_out[g * p + tid] = sm.K[tid];
    rho_out[g * p + tid] = s_rho[tid];
  }
  if (tid == 0) {
    ran_bs[g] = 1;
    rounds_out[g] = rounds;
  }
}

extern "C" int dn_trim_loop(
    const float* Fm, const int* bin_id, const float* bin_count,
    const float* K0, float* E, const float* rho0, const float* u0,
    const int* n_hi, const int* n_bins, const uint8_t* active0, float* X,
    uint8_t* colmask, float* K, float* rho, uint8_t* ran_bs,
    int* rounds_active, int G, int p, int W, int B, int nmf_iter,
    int power_resume, int power_warm, int warm_plain, int max_rounds,
    int min_bins, int min_gene_len, int threads, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t dyn = (size_t)W * sizeof(float);
#define CALL(PM)                                                              \
  trim_loop_kernel<PM><<<G, threads, dyn, st>>>(                              \
      Fm, bin_id, bin_count, K0, E, rho0, u0, n_hi, n_bins, active0, X,       \
      colmask, K, rho, ran_bs, rounds_active, p, W, B, nmf_iter,              \
      power_resume, power_warm, warm_plain, max_rounds, min_bins,             \
      min_gene_len)
  DN_DISPATCH_P(p, CALL);
#undef CALL
  return (int)cudaGetLastError();
}
