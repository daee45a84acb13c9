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
//   * above (dn_trim_phase): THE PHASED LAYOUT.  The round is cut into
//     launches over the whole card, each sized to its work: the scores (a
//     block a (gene, tile of 64 columns)), the bin choice and column mask
//     (a block a gene), each round's NMF loop on kernel 1's phased layout
//     (phase.cuh, stream_phase.cu's phase_loop: the genes in the round
//     listed on the card, in groups of at most an SM's worth, a gene's
//     panel pairs a block each), the DI refresh (a block a (gene, 8
//     rows)) and the round's end (a block a gene).  The trim state (u, E,
//     K, rho, the bins, the count) lives in device memory between the
//     launches; the caller's E0 is only read.  Past 640 samples the
//     resident gate leaves a gene at most 102 columns, so on every default
//     setting no gene has the min_gene_len columns a round needs: after
//     the set-up launch the host waits once and reads whether any gene
//     enters from page-locked memory the launch writes, and stops there.
//     Every sum is the block layout's this replaced (one block a gene, B
//     in a workspace), in its order, so the results are its bits.
#include "phase.cuh"
#include "trim.cuh"

// ---- past DN_PCL_MAX_P: the rounds on the phased layout --------------------
// The trim state of the phased rounds, in the workspace after the phased
// layout's own (dn_phase_ws_floats(p, slots, G) floats): u (G x p), E
// (G x W: the caller's E0 is only read), the round's residual scores (G x
// W), DN_TRIM_ST ints a gene, the round's Lagrangian iterations (G ints),
// the count of genes in a round's NMF loop, then bytes: whether a gene is
// in the round's loop (G) and its bins' flags (G x B).
constexpr int DN_TRIM_ST = 6;
constexpr int DN_TS_NHI = 0;      // surviving columns
constexpr int DN_TS_NBINS = 1;    // surviving bins
constexpr int DN_TS_ALIVE = 2;    // still in the loop
constexpr int DN_TS_CLIPPED = 3;  // scored against the clipped estimate
constexpr int DN_TS_ROUNDS = 4;   // rounds entered
constexpr int DN_TS_ITERS = 5;    // Lagrangian iterations over them

__host__ __device__ inline size_t dn_trim_phase_floats(int p, int W, int B,
                                                       int G) {
  return (size_t)G * p + 2 * (size_t)G * W + (size_t)G * (DN_TRIM_ST + 1) +
         1 + ((size_t)G * (B + 1) + 3) / 4;
}

struct TrimPh {
  float* u;
  float* E;
  float* res;
  int* st;
  int* iters_r;
  int* cnt;
  uint8_t* in_round;
  uint8_t* bins;
  TrimPh(float* base, int p, int W, int G) {
    u = base;
    E = u + (size_t)G * p;
    res = E + (size_t)G * W;
    st = (int*)(res + (size_t)G * W);
    iters_r = st + (size_t)G * DN_TRIM_ST;
    cnt = iters_r + G;
    in_round = (uint8_t*)(cnt + 1);
    bins = in_round + G;
  }
};

// A gene leaves the loop: its rounds and iterations (ran_bs, K and rho are
// already its results).  One thread.
__device__ __forceinline__ void trim_ph_finish(const TrimArgs& a, int* st,
                                               size_t g) {
  a.rounds_active[g] = st[DN_TS_ROUNDS];
  if (a.iters != nullptr) a.iters[g] = st[DN_TS_ITERS];
  st[DN_TS_ALIVE] = 0;
}

// The set-up, a block a gene at a time: every gene's results start as the
// loop-never-ran ones (K0, rho0; ran_bs its active0, 0 rounds), and an
// active gene's state as the block layout's (u0, E0, its bins, n_hi,
// n_bins); a gene that goes into round 1 writes the call's number `call`
// into `flag`, an int of page-locked host memory mapped for the card.
__global__ void __launch_bounds__(DN_WIDE_THREADS, 1)
    trim_ph_init_kernel(TrimArgs a, TrimPh t, volatile int* flag, int call) {
  const int tid = threadIdx.x, nt = blockDim.x, p = a.p;
  for (size_t g = blockIdx.x; g < (size_t)a.G; g += gridDim.x) {
    const bool on = a.active0[g] != 0;
    for (int i = tid; i < p; i += nt) {
      a.K[g * p + i] = a.K0[g * p + i];
      a.rho[g * p + i] = a.rho0[g * p + i];
      if (on) t.u[g * p + i] = a.u0[g * p + i];
    }
    if (!on) {
      if (tid == 0) {
        t.st[g * DN_TRIM_ST + DN_TS_ALIVE] = 0;
        t.in_round[g] = 0;
        a.ran_bs[g] = 0;
        a.rounds_active[g] = 0;
        if (a.iters != nullptr) a.iters[g] = 0;
      }
      continue;
    }
    for (int l = tid; l < a.W; l += nt) t.E[g * a.W + l] = a.E[g * a.W + l];
    for (int b = tid; b < a.B; b += nt) t.bins[g * a.B + b] = b < a.n_bins[g];
    if (tid == 0) {
      int* st = t.st + g * DN_TRIM_ST;
      const bool alive = a.max_rounds > 0;
      st[DN_TS_NHI] = a.n_hi[g];
      st[DN_TS_NBINS] = a.n_bins[g];
      st[DN_TS_ALIVE] = alive;
      st[DN_TS_CLIPPED] = 0;
      st[DN_TS_ROUNDS] = 0;
      st[DN_TS_ITERS] = 0;
      t.in_round[g] = 0;
      a.ran_bs[g] = 1;
      a.rounds_active[g] = 0;
      if (a.iters != nullptr) a.iters[g] = 0;
      if (alive) *flag = call;
    }
  }
}

// A round's scores: block (gene, tile of 64 columns), thread (q, c) rows q,
// q + 4, ... of column c; the worst squared relative residual of each
// active column (round 1 against the unclipped estimate, later rounds the
// clipped one), the four quarters' maxima combined (a max: any order gives
// the block layout's bits).
__global__ void __launch_bounds__(DN_WIDE_THREADS)
    trim_ph_score_kernel(TrimArgs a, TrimPh t) {
  __shared__ float part[4][DN_WIDE_TC];
  const size_t g = blockIdx.x;
  const int* st = t.st + g * DN_TRIM_ST;
  if (st[DN_TS_ALIVE] == 0) return;
  const int tid = threadIdx.x, q = tid >> 6, c = tid & (DN_WIDE_TC - 1);
  const int p = a.p, W = a.W, l = blockIdx.y * DN_WIDE_TC + c;
  const bool clipped = st[DN_TS_CLIPPED] != 0;
  bool on = false;
  if (l < W) {
    const int b = a.bin_id[g * W + l];
    on = b < a.B && t.bins[g * a.B + b] != 0;
  }
  float r = 0.f;
  if (on) {
    const float e = t.E[g * W + l];
    const float* Fg = a.Fm + g * p * W + l;
    const float* Kg = a.K + g * p;
    for (int i = q; i < p; i += 4) {
      const float f = Fg[(size_t)i * W];
      float ke = __fmul_rn(Kg[i], e);  // no FMA into the subtraction
      if (clipped) ke = fmaxf(ke, f);
      const float z = (ke - f) / (f + 1.0f);
      r = fmaxf(r, z * z);
    }
  }
  part[q][c] = r;
  __syncthreads();
  if (q == 0 && l < W)
    t.res[g * W + l] = fmaxf(fmaxf(part[0][c], part[1][c]),
                             fmaxf(part[2][c], part[3][c]));
}

// A round's bin choice, a block a gene: the per-bin sums (warp q bins q, q +
// 8, ..., lane order, the block layout's), the first arg-max bin dropped,
// n_hi and n_bins; a gene that stops (a perfect fit, or under 2 columns:
// nmf.py:286-287, :306-310) leaves with its results as they are, one that
// goes on gets its column mask and a place in the round's list.
__global__ void __launch_bounds__(DN_WIDE_THREADS)
    trim_ph_bins_kernel(TrimArgs a, TrimPh t) {
  __shared__ float s_ss[DN_MAX_BINS];
  __shared__ int s_go;
  const size_t g = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  int* st = t.st + g * DN_TRIM_ST;
  if (st[DN_TS_ALIVE] == 0) {
    if (tid == 0) t.in_round[g] = 0;
    return;
  }
  const int W = a.W, B = a.B;
  const int* bid = a.bin_id + g * W;
  const float* res = t.res + g * W;
  uint8_t* bins = t.bins + g * B;
  for (int b = warp; b < B; b += nw) {
    float s = 0.f;
    for (int w = lane; w < W; w += 32)
      if (bid[w] == b) s += res[w];
    s = warp_sum(s);
    if (lane == 0) s_ss[b] = s;
  }
  __syncthreads();
  if (tid == 0) {
    ++st[DN_TS_ROUNDS];  // this gene is active in this round
    const float* cnt = a.bin_count + g * B;
    float mx = 0.f;
    int drop = 0;
    for (int b = 0; b < B; ++b) {
      const float v = bins[b] ? s_ss[b] / fmaxf(cnt[b], 1.0f) : DN_NEG;
      if (b == 0 || v > mx) {  // strict: ties go to the lower index
        mx = v;
        drop = b;
      }
    }
    int go = 0;
    if (mx != 0.0f) {
      bins[drop] = 0;
      st[DN_TS_NHI] -= (int)cnt[drop];
      st[DN_TS_NBINS] -= 1;
      go = st[DN_TS_NHI] >= 2;
    }
    t.in_round[g] = go;
    if (go)
      atomicAdd(t.cnt, 1);
    else
      trim_ph_finish(a, st, g);
    s_go = go;
  }
  __syncthreads();
  if (!s_go) return;
  uint8_t* cm = a.colmask + g * W;
  for (int w = tid; w < W; w += nt) {
    const int b = bid[w];
    cm[w] = (b < B && bins[b]) ? 1 : 0;
  }
}

// sum_w E[w] of a gene as the block layout's finish summed it: thread c <
// 64 of the block its columns c, c + 64, ... in order, then panel_sum.
// Whole block.
__device__ __forceinline__ float trim_ph_sum_e(const float* Eg, int W,
                                               float* red) {
  float se = 0.f;
  if (threadIdx.x < DN_WIDE_TC)
    for (int l = threadIdx.x; l < W; l += DN_WIDE_TC) se += Eg[l];
  return panel_sum(red, se);
}

// min_i K_i sum_w E[w]: zero where a fitted sample is all zeros
// (nmf.py:315-316).
__device__ __forceinline__ float trim_ph_min_rs(const float* Kg, int p,
                                                float sumE) {
  float m = INFINITY;
  for (int i = 0; i < p; ++i) m = fminf(m, __fmul_rn(Kg[i], sumE));
  return m;
}

// The clipped DI refresh of a round (nmf.py:318-321): block (gene, 8 rows),
// warp q row 8 y + q over the surviving columns (lane order, warp_sum: the
// block layout's), rho written over the last; none where min_rs is zero.
__global__ void __launch_bounds__(DN_WIDE_THREADS)
    trim_ph_refresh_kernel(TrimArgs a, TrimPh t) {
  __shared__ float red[32];
  const size_t g = blockIdx.x;
  if (t.in_round[g] == 0) return;
  const int p = a.p, W = a.W, lane = threadIdx.x & 31;
  const float* Eg = t.E + g * W;
  const float* Kg = a.K + g * p;
  const float sumE = trim_ph_sum_e(Eg, W, red);
  if (trim_ph_min_rs(Kg, p, sumE) == 0.0f) return;
  const int i = blockIdx.y * (DN_WIDE_THREADS / 32) + (threadIdx.x >> 5);
  if (i >= p) return;
  const uint8_t* cm = a.colmask + g * W;
  const float* Fi = a.Fm + (g * p + i) * W;
  const float Ki = Kg[i];
  float rf = 0.f, re = 0.f;
  for (int w = lane; w < W; w += 32) {
    if (cm[w] == 0) continue;
    const float f = Fi[w];
    rf += f;
    re += fmaxf(Ki * Eg[w], f);
  }
  rf = warp_sum(rf);
  re = warp_sum(re);
  if (lane == 0) a.rho[g * p + i] = 1.0f - rf / (re + 1.0f);
}

// A round's end, a block a gene of the round: its iterations; a gene with
// an all-zero fitted sample stops with the new K and the last rho, else it
// goes on while it is above its floors (nmf.py:323-324) and its largest
// rho is over 0.1 (nmf.py:273); `last`: the round was the last one.
__global__ void __launch_bounds__(DN_WIDE_THREADS)
    trim_ph_close_kernel(TrimArgs a, TrimPh t, int last) {
  __shared__ float red[32];
  const size_t g = blockIdx.x;
  if (t.in_round[g] == 0) return;
  const int p = a.p, lane = threadIdx.x & 31;
  int* st = t.st + g * DN_TRIM_ST;
  const float sumE = trim_ph_sum_e(t.E + g * a.W, a.W, red);
  const bool refreshed = trim_ph_min_rs(a.K + g * p, p, sumE) != 0.0f;
  if (threadIdx.x >= 32) return;
  int go = 0;
  if (refreshed) {
    float mx = -INFINITY;
    for (int i = lane; i < p; i += 32) mx = fmaxf(mx, a.rho[g * p + i]);
    mx = warp_max(mx);
    const bool floor_hit = st[DN_TS_NBINS] <= a.min_bins ||
                           st[DN_TS_NHI] < a.min_gene_len;
    go = !floor_hit && mx > 0.1f;
  }
  if (lane == 0) {
    st[DN_TS_ITERS] += t.iters_r[g];
    st[DN_TS_CLIPPED] = 1;
    if (!go || last) trim_ph_finish(a, st, g);
  }
}

// This host thread's page-locked ints (allocated at its first call): [0]
// mapped for the card (the set-up's flag), [1] a count's copy.
static int trim_ph_host(int** h, int** d) {
  static thread_local int* host = nullptr;
  static thread_local int* dev = nullptr;
  cudaError_t e = cudaSuccess;
  if (host == nullptr) {
    e = cudaHostAlloc((void**)&host, 2 * sizeof(int), cudaHostAllocMapped);
    if (e == cudaSuccess) e = cudaHostGetDevicePointer((void**)&dev, host, 0);
    if (e != cudaSuccess) host = nullptr;
  }
  *h = host;
  *d = dev;
  return (int)e;
}

// A count on the card into *n through the page-locked int h: the stream's
// work so far is waited for.
static int trim_ph_read(const int* d, int* h, int* n, cudaStream_t st) {
  cudaError_t e =
      cudaMemcpyAsync(h, d, sizeof(int), cudaMemcpyDeviceToHost, st);
  if (e == cudaSuccess) e = cudaStreamSynchronize(st);
  if (e == cudaSuccess) *n = *h;
  return (int)e;
}

// The whole loop past DN_PCL_MAX_P: the set-up, then a round at a time its
// scores, its bin choice, the NMF loop of the genes in it on the phased
// layout (stream_phase.cu's phase_loop over the round's list, X row by row
// in the scratch, u, K and E the state's, the outputs of the genes off the
// list kept), the DI refresh and the round's end.  The host reads whether
// any gene enters after the set-up and the count of genes going on once a
// round: a bucket that no gene enters costs the set-up launch and one
// wait, and a round's loop runs only the groups its genes fill.
static int dn_trim_phase(const TrimArgs& a, int mode) {
  if (!phase_fits(a.p) || a.ws == nullptr || a.ws_slots < 1)
    return (int)cudaErrorInvalidValue;
  if (a.G == 0) return 0;
  const int S = a.ws_slots, p = a.p, W = a.W;
  const cudaStream_t st = a.stream;
  TrimPh t(a.ws + dn_phase_ws_floats(p, S, a.G), p, W, a.G);
  const unsigned G = (unsigned)a.G;
  static thread_local int calls = 0;
  const int call = ++calls;
  int *h, *hd;
  int e = trim_ph_host(&h, &hd);
  if (e == 0) {
    trim_ph_init_kernel<<<G < 4096 ? G : 4096, DN_WIDE_THREADS, 0, st>>>(
        a, t, hd, call);
    e = (int)cudaGetLastError();
  }
  if (e == 0) e = (int)cudaStreamSynchronize(st);
  if (e != 0 || *(volatile int*)h != call) return e;  // no gene enters
  int n = 0;
  const bool fast = mode == DN_TRIM_FAST;
  PhaseArgs pa = {};
  pa.F = a.Fm;
  pa.mask = a.colmask;
  pa.X = a.X;
  pa.u0 = t.u;  // each round's cold step resumes from the last round's u
  pa.K = a.K;
  pa.E = t.E;
  pa.u = t.u;
  pa.iters = t.iters_r;
  pa.G = a.G;
  pa.p = p;
  pa.W = W;
  // trim_fast: max(nmf_iter / 4, 8) steps a round, its cold refit at
  // power_warm, the X held from the second round on
  pa.nmf_iter = fast ? (a.nmf_iter / 4 > 8 ? a.nmf_iter / 4 : 8) : a.nmf_iter;
  pa.tol = mode == DN_TRIM_TOL && a.tol > 0.f ? a.tol : 0.f;
  pa.keep = 1;
  phase_parts(pa, a.ws, S, false);
  const int n_cold = fast ? a.power_warm : a.power_resume;
  const dim3 tiles(G, (unsigned)((W + DN_WIDE_TC - 1) / DN_WIDE_TC));
  const dim3 rows(G, (unsigned)((p + 7) / 8));
  for (int r = 1; e == 0 && r <= a.max_rounds; ++r) {
    e = (int)cudaMemsetAsync(t.cnt, 0, sizeof(int), st);
    if (e != 0) break;
    trim_ph_score_kernel<<<tiles, DN_WIDE_THREADS, 0, st>>>(a, t);
    trim_ph_bins_kernel<<<G, DN_WIDE_THREADS, 0, st>>>(a, t);
    e = (int)cudaGetLastError();
    if (e == 0) e = trim_ph_read(t.cnt, h + 1, &n, st);
    if (e != 0 || n == 0) break;
    pa.from_x = fast && r > 1;
    pa.listed = n;
    e = phase_loop(pa, false, t.in_round, nullptr, S, n_cold, a.power_warm,
                   a.warm_plain, st);
    if (e != 0) break;
    trim_ph_refresh_kernel<<<rows, DN_WIDE_THREADS, 0, st>>>(a, t);
    trim_ph_close_kernel<<<G, DN_WIDE_THREADS, 0, st>>>(a, t,
                                                        r == a.max_rounds);
    e = (int)cudaGetLastError();
  }
  return e;
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
  return dn_trim_phase(a, mode);
}
