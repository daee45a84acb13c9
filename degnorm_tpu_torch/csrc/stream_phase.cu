// Kernel 4 past DN_PCL_MAX_P_STREAM samples: the Lagrangian NMF-OA loop of
// a streamed bucket on phase.cuh's phased layout, both input forms (raw
// int16 + scale, float32) in this one translation unit.  stream_panel.cu's
// dn_stream_panel hands p past its cluster layout here; nmf_panel.cu's
// dn_nmf_panel hands kernel 1 past its own (DN_PCL_MAX_P) to the same loop
// (phase_loop), on float32 input, with its nmf_tol branch.
//
// Replaces, for studies of more than 1,152 samples, the TPU kernel
// degnorm_tpu/ops/pallas_stream.py::nmf_masked_streamed (_stream_kernel),
// with the same arguments, input forms and results (its block layout's
// bits), as stream_panel.cu does up to 1,152.  Bound on this card: the
// Gram's float32 operations, T(T+1)/2 x 128^2 fmas a column a sweep
// (phase.cuh).  A call: one launch to list the active genes, then for each
// group of at most `slots` of them X = A0, the cold Gram, B^2 and power
// step, nmf_iter times the update, the Gram (B^2 where the warm refit is
// squared) and the power step, and the finish: 3 nmf_iter + 6 launches at
// one group and warm_plain > 0.  This file also holds the kernels that
// kernel 2's phased layout (ratio_phase.cu) launches too: the list of
// active genes, B^2's Gram and the power step.
#include "phase.cuh"
#include "stream.cuh"

// The list of active genes in order (block 0: act null takes every gene),
// kernel 4's scales of int16 input and their reciprocals, every
// slot's largest entry zeroed; each block zeroes the outputs of its
// inactive genes (kernel 4: K, E, u), unless a.keep (kernel 3's rounds).
__global__ void __launch_bounds__(DN_WIDE_THREADS)
    phase_prep_kernel(PhaseArgs a, const uint8_t* __restrict__ act,
                      const float* __restrict__ scale, int slots) {
  const int t = threadIdx.x, lane = t & 31, wp = t >> 5;
  if (blockIdx.x == 0) {
    __shared__ int cnt[DN_WIDE_THREADS / 32];
    __shared__ int total;
    if (t == 0) total = 0;
    __syncthreads();
    for (int g0 = 0; g0 < a.G; g0 += DN_WIDE_THREADS) {
      const int g = g0 + t;
      const bool on = g < a.G && (act == nullptr || act[g] != 0);
      const unsigned bal = __ballot_sync(DN_FULL, on);
      if (lane == 0) cnt[wp] = __popc(bal);
      __syncthreads();
      int off = total;
      for (int k = 0; k < wp; ++k) off += cnt[k];
      if (on) a.list[1 + off + __popc(bal & ((1u << lane) - 1u))] = g;
      __syncthreads();
      if (t == 0)
        for (int k = 0; k < DN_WIDE_THREADS / 32; ++k) total += cnt[k];
      __syncthreads();
    }
    if (t == 0) a.list[0] = total;
    if (a.ss != nullptr)
      for (int i = t; i < dn_panel_np(a.p); i += DN_WIDE_THREADS) {
        const float sv = (scale != nullptr && i < a.p) ? scale[i] : 1.0f;
        a.ss[i] = sv;
        a.rs[i] = 1.0f / sv;
      }
    for (int s = t; s < slots; s += DN_WIDE_THREADS)
      *PhaseSlot(a.ws, s, a.p).bmax() = 0;
  }
  if (act == nullptr || a.keep) return;
  for (size_t g = blockIdx.x; g < (size_t)a.G; g += gridDim.x) {
    if (act[g] != 0) continue;
    for (int i = t; i < a.p; i += DN_WIDE_THREADS) {
      a.K[g * a.p + i] = 0.f;
      a.u[g * a.p + i] = 0.f;
    }
    for (int l = t; l < a.W; l += DN_WIDE_THREADS) a.E[g * a.W + l] = 0.f;
    if (t == 0 && a.iters != nullptr) a.iters[g] = 0;
  }
}

// y = (scale M) x by the cluster (M = B or B^2 of the slot, symmetric, rows
// of ldb floats): block `rank` its rows rank RB .. , thread i summing column
// i (= row i) in column order j as panel_matvec does (64 loads in flight a
// thread: with a few genes, the card's few busy SMs wait on them),
// published in its shared memory (two halves by parity: a half is written
// again two matvecs later, after the next one's barrier, by which every
// block has copied it), one cluster barrier, and every block copies the
// whole y.  Ends with a barrier: y is visible.
struct PhaseMv {
  int p, ldb, RB, rank, n;
  float* pub;
  __device__ __forceinline__ void run(const float* __restrict__ M,
                                      float scale, const float* x, float* y) {
    cg::cluster_group cl = cg::this_cluster();
    const int par = (n & 1) * RB;
    ++n;
    const int r0 = rank * RB, r1 = p - r0 < RB ? p : r0 + RB;
    for (int i = r0 + threadIdx.x; i < r1; i += DN_WIDE_THREADS) {
      float v = 0.f;
      const float* Mi = M + i;
#pragma unroll 64
      for (int j = 0; j < p; ++j)
        v = fmaf(__ldg(Mi + (size_t)j * ldb) * scale, x[j], v);
      pub[par + i - r0] = v;
    }
    cl.sync();  // every block's rows are published
    for (int i = threadIdx.x; i < p; i += DN_WIDE_THREADS)
      y[i] = cl.map_shared_rank(pub, i / RB)[par + i % RB];
    __syncthreads();
  }
};

// The power step of a group's genes, as panel_refit: a cluster of
// DN_PHASE_C blocks a gene, every block holding the whole u, the same in
// each (`cold`: from u0, or 1 / sqrt(p), else the slot's u); n_plain > 0
// plain matvecs on the normalised B and one normalisation, else
// max(1, n_squared / 4) bodies of two B^2 matvecs (B^2 from the Gram
// launch); with `finish`, s = sqrt(max(u^T B u, 0)) into the slot.  u comes
// back into the slot, and its largest entry is zeroed for the next Gram.
// Under nmf_tol (a.tol > 0, a warm step: finish set) the first block also
// compares K = u s with the slot's last (wide_core's freeze test, its
// panel_max): a gene that moved by at most tol max|K| is frozen after
// sweep a.iter, and its iterations set to a.iter + 1.
__global__ void __launch_bounds__(DN_WIDE_THREADS, 1)
    phase_power_kernel(PhaseArgs a, int n_squared, int n_plain, int finish,
                       int cold) {
  extern __shared__ float4 dyn4[];
  cg::cluster_group cl = cg::this_cluster();
  const int t = threadIdx.x, slot = blockIdx.x / DN_PHASE_C;
  const int g = phase_gene(a, slot);
  if (g < 0) return;  // (the whole cluster: one slot)
  const int p = a.p, np = dn_panel_np(p);
  const PhaseSlot sl(a.ws, slot, p);
  float* u = (float*)dyn4;
  float* va = u + np;
  float* vb = va + np;
  float* red = vb + np;
  PhaseMv mv{p, dn_phase_ldb(p), dn_phase_rows(p), (int)cl.block_rank(), 0,
             red + 32};
  for (int i = t; i < np; i += DN_WIDE_THREADS)
    u[i] = i < p ? (!cold        ? sl.u[i]
                    : a.u0 != nullptr ? a.u0[(size_t)g * p + i]
                                      : 1.0f / sqrtf((float)p))
                 : 0.f;
  __syncthreads();
  if (n_plain > 0) {
    const float inv = 1.0f / (__int_as_float(*sl.bmax()) + DN_EPS);
    const float* x = u;
    for (int it = 0; it < n_plain; ++it) {
      float* y = (it & 1) ? vb : va;
      mv.run(sl.B, inv, x, y);
      x = y;
    }
    panel_renormalize(red, p, x, u);
  } else {
    int n_bodies = n_squared / 4;
    if (n_bodies < 1) n_bodies = 1;
    for (int it = 0; it < n_bodies; ++it) {
      mv.run(sl.B2, 1.f, u, va);
      mv.run(sl.B2, 1.f, va, vb);
      panel_renormalize(red, p, vb, u);
    }
  }
  float s = 0.f;
  if (finish) {
    mv.run(sl.B, 1.f, u, va);
    float ubu = 0.f;
    for (int j = t; j < p; j += DN_WIDE_THREADS) ubu = fmaf(u[j], va[j], ubu);
    s = sqrtf(fmaxf(panel_sum(red, ubu), 0.f));
  }
  if (mv.rank == 0) {
    if (a.tol > 0.f && !cold) {
      const float s_old = sl.scal[0];
      float delta = 0.f, ref = 0.f;
      for (int j = t; j < p; j += DN_WIDE_THREADS) {
        const float k_new = __fmul_rn(u[j], s);
        delta = fmaxf(delta, fabsf(k_new - __fmul_rn(sl.u[j], s_old)));
        ref = fmaxf(ref, fabsf(k_new));
      }
      delta = panel_max(red, delta);
      ref = fmaxf(panel_max(red, ref), DN_EPS);
      if (delta <= __fmul_rn(a.tol, ref) && t == 0) {  // that update kept
        *sl.frozen() = 1;
        *sl.ran() = a.iter + 1;
      }
    }
    for (int i = t; i < p; i += DN_WIDE_THREADS) sl.u[i] = u[i];
    if (finish && t == 0) sl.scal[0] = s;
  }
  cl.sync();  // B's largest entry and every block's rows are read
  if (mv.rank == 0 && t == 0) *sl.bmax() = 0;
}

int phase_prep(const PhaseArgs& pa, const uint8_t* act, const float* scale,
               int slots, cudaStream_t st) {
  return phase_launch(phase_prep_kernel, (unsigned)(pa.G < 1024 ? pa.G : 1024),
                      1, 0, false, st, pa, act, scale, slots);
}

int phase_power(const PhaseArgs& pa, int slots, int n_squared, int n_plain,
                int finish, int cold, bool square, cudaStream_t st) {
  int e = 0;
  if (square)
    e = phase_launch(phase_gram_kernel<DN_PH_B, false>,
                     (unsigned)dn_pcl_pairs(pa.p), slots,
                     sizeof(float) * dn_phase_gram_floats(), false, st, pa);
  if (e == 0)
    e = phase_launch(phase_power_kernel, 0, slots,
                     sizeof(float) * dn_phase_power_floats(pa.p), true, st,
                     pa, n_squared, n_plain, finish, cold);
  return e;
}

template <bool I16>
static int phase_loop_form(PhaseArgs a, const uint8_t* act,
                           const float* scale, int S, int power_cold,
                           int power_warm, int warm_plain, cudaStream_t st) {
  int e = phase_prep(a, act, scale, S, st);
  const unsigned tiles = (unsigned)((a.W + DN_WIDE_TC - 1) / DN_WIDE_TC);
  const unsigned cols = tiles > 0 ? tiles : 1;
  const unsigned pairs = (unsigned)dn_pcl_pairs(a.p);
  const size_t gram = sizeof(float) * dn_phase_gram_floats();
  const bool adapt = a.tol > 0.f;  // every refit computes s
  const auto gram_x = [&]() {
    return phase_launch(phase_gram_kernel<DN_PH_X, false>, pairs, S, gram,
                        false, st, a);
  };
  const int listed = a.listed > 0 && a.listed < a.G ? a.listed : a.G;
  for (int base = 0; e == 0 && base < listed; base += S) {
    a.base = base;
    e = phase_launch(phase_cols_kernel<DN_PHC_XINIT, I16>, cols, S, 0, false,
                     st, a);
    if (e == 0) e = gram_x();
    if (e == 0)
      e = phase_power(a, S, power_cold, 0, adapt || a.nmf_iter == 0, 1, true,
                      st);
    for (int it = 0; e == 0 && it < a.nmf_iter; ++it) {
      a.iter = it;
      e = phase_launch(phase_cols_kernel<DN_PHC_UPDATE, I16>, cols, S, 0,
                       false, st, a);
      if (e == 0) e = gram_x();
      if (e == 0)
        e = phase_power(a, S, power_warm, warm_plain,
                        adapt || it == a.nmf_iter - 1, 0, warm_plain <= 0, st);
    }
    if (e == 0)
      e = phase_launch(phase_cols_kernel<DN_PHC_FINISH, I16>, cols, S, 0,
                       false, st, a);
  }
  return e;
}

int phase_loop(const PhaseArgs& a, bool i16, const uint8_t* act,
               const float* scale, int slots, int power_cold, int power_warm,
               int warm_plain, cudaStream_t st) {
  return i16 ? phase_loop_form<true>(a, act, scale, slots, power_cold,
                                     power_warm, warm_plain, st)
             : phase_loop_form<false>(a, act, scale, slots, power_cold,
                                      power_warm, warm_plain, st);
}

int dn_stream_phase(const StreamArgs& a) {
  if (!dn_phase_on(a.p, DN_PCL_STREAM) || !phase_fits(a.p) ||
      a.ws == nullptr || a.ws_slots < 1)
    return (int)cudaErrorInvalidValue;
  if (a.G == 0) return 0;
  PhaseArgs pa = {};
  pa.F = a.F;
  pa.mask = a.mask;
  pa.X = a.X;
  pa.u0 = a.u0;
  pa.K = a.K;
  pa.E = a.E;
  pa.u = a.u;
  pa.G = a.G;
  pa.p = a.p;
  pa.W = a.W;
  pa.nmf_iter = a.nmf_iter;
  phase_parts(pa, a.ws, a.ws_slots, a.scale != nullptr);
  return phase_loop(pa, a.scale != nullptr, a.act, a.scale, a.ws_slots,
                    a.power_cold, a.power_warm, a.warm_plain, a.st);
}
