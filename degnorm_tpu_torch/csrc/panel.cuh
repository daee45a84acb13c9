// Shared device code of the DegNorm CUDA kernels for p > 128 samples
// (sm_90a, plain float32): the Lagrangian NMF-OA loop of one gene with its
// p x p Gram cut into row panels of DN_PANEL_ROWS, in a workspace in device
// memory, and the power step run by the whole block.
//
// Replaces, for studies of more than 128 samples, wide.cuh's core (and so
// the same TPU code: degnorm_tpu/ops/pallas_nmf.py's _gram, _power,
// _power_warm and _nmf_loop, which ops/pallas_trim.py and
// ops/pallas_stream.py use the same way).  The TPU kernels have no cap on p;
// wide.cuh's layout stops at 128, because its Gram sits in shared memory as
// PMAX x (PMAX + 4) floats (266 KB at 256, against the 227 KB a block may
// have) and a thread's register tile of it is (PMAX / 16)^2 (256 registers
// at 256).  One instance here takes every p above 128.
//
// The layout (chosen over a cluster of blocks, one panel pair a block, as
// the simplest that is right; that is a later redesign):
//   * p is cut into T = ceil(p / 128) row panels.  The Gram's upper-triangle
//     panel pairs (I <= J), T(T+1)/2 of them, are each accumulated over the
//     gene's columns by wide.cuh's 8 x 8 register tile of WideGram<128>
//     (syrk2: rows of panel I against rows of panel J of a tile of 64
//     columns staged in shared memory), one pair a pass, and stored with
//     their mirror into B, p x p floats in the block's workspace (device
//     memory, L2-resident for the blocks in flight).  A diagonal pair
//     computes its two triangles with the same products in the same order,
//     so B is exactly symmetric.  3 passes a sweep at p = 256, 10 at 512;
//   * a merged sweep is one pass of its own first: per tile, v = X^T u over
//     all p rows (a thread's partial over its rows of every panel, then the
//     four quarters in a fixed order) and the multiplier update of X in the
//     global scratch; the Gram passes then read the new X back (L2);
//   * the power step is the block's, on B in the workspace: B's largest
//     entry by a block reduction, each matvec a thread a row in column
//     order, B^2 of the squared scheme by the same panel pairs over B's own
//     rows (into B2 in the workspace), each norm and dot product a block
//     sum in a fixed order, so u is bit-equal across two runs;
//   * a block works through genes blockIdx.x, + gridDim.x, ...: the launch
//     has at most one block an SM (its register tile takes up to 255
//     registers), so the workspace is sized by the genes in flight, not by
//     the bucket (`dn_panel_ws_floats` a block).
//
// What bounds it on this card: float32 operations, p(p+1) a column a sweep
// for the Gram, of which the panel pairs compute T(T+1)/2 x 128^2 (the
// diagonal pairs whole, and rows past p as zeros).  X is read T(T+1)/2 + 2
// times a sweep, from L2 where the genes in flight fit it.
//
// Shared memory: two tiles of 64 columns x (128 + 4) floats, the v
// partials and 32 floats of scratch, 68,736 bytes whatever p; kernel 3 adds
// its W residual scores.  The workspace holds B, B2 and nine vectors of
// ceil(p / 128) * 128 floats (u, three matvec results, the previous u, and
// four for the kernel: kernel 3's K, rho and DI row sums, kernel 2's row
// sums, kernel 4's scales and their reciprocals), zero beyond p.
//
// Kept from common.cuh and wide.cuh: sums in a fixed order and no float
// atomics; plain FP32; no -use_fast_math.
#pragma once

#include "wide.cuh"

#define DN_PANEL_ROWS 128                  // rows of a panel (WideGram<128>)
#define DN_PANEL_LD (DN_PANEL_ROWS + 4)    // floats a row of a staged tile
#define DN_PANEL_VECS 9                    // p-vectors of a block's workspace
#define DN_PANEL_MIN_P 129                 // at and below 128: wide.cuh

// Rows of the panels that hold p (a whole number of panels).
__host__ __device__ inline int dn_panel_np(int p) {
  return (p + DN_PANEL_ROWS - 1) / DN_PANEL_ROWS * DN_PANEL_ROWS;
}

// Floats of one block's workspace: B and B2, then the vectors.
__host__ __device__ inline size_t dn_panel_ws_floats(int p) {
  return 2 * (size_t)p * p + (size_t)DN_PANEL_VECS * dn_panel_np(p);
}

// Floats of the core's shared memory (dynamic, sized at launch).
__host__ __device__ constexpr int panel_smem_floats() {
  return 2 * DN_WIDE_TC * DN_PANEL_LD + 4 * DN_WIDE_TC + 32;
}

struct PanelWork {
  float* SI;     // TC x LD: rows of panel I of a tile (shared)
  float* SJ;     // TC x LD: rows of panel J
  float* vpart;  // 4 x TC: the quarters' partials of v
  float* red;    // 32: block reductions
  float* B;      // p x p: the gene's Gram (workspace)
  float* B2;     // p x p: B^2 of the squared scheme
  float* u;      // np: the left vector (zero beyond p)
  float* va;     // np: matvec results
  float* vb;
  float* vc;
  float* uo;     // np: the previous u (ADAPT)
  float* x[4];   // np each: the kernel's own
  int p, np, T;
  __device__ __forceinline__ void init(float* smem, float* ws, int p_) {
    p = p_;
    np = dn_panel_np(p_);
    T = np / DN_PANEL_ROWS;
    SI = smem;
    SJ = SI + DN_WIDE_TC * DN_PANEL_LD;
    vpart = SJ + DN_WIDE_TC * DN_PANEL_LD;
    red = vpart + 4 * DN_WIDE_TC;
    B = ws;
    B2 = B + (size_t)p * p;
    u = B2 + (size_t)p * p;
    va = u + np;
    vb = va + np;
    vc = vb + np;
    uo = vc + np;
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = uo + (k + 1) * np;
  }
};

// The block's sum of its threads' values in a fixed order (warps, then the
// warps' sums in order), and its largest value: the same in every thread.
// Each starts and ends with a barrier of its own use of `red`.
__device__ __forceinline__ float panel_sum(float* red, float v) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = 0.f;
#pragma unroll
  for (int k = 0; k < DN_WIDE_THREADS / 32; ++k) r += red[k];
  __syncthreads();
  return r;
}

__device__ __forceinline__ float panel_max(float* red, float v) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int k = 1; k < DN_WIDE_THREADS / 32; ++k) r = fmaxf(r, red[k]);
  __syncthreads();
  return r;
}

// This thread's 32 rows of panel P of its column of a tile into S (column
// c's rows contiguous), from val(i); zeros off `on` and past p.
template <class Val>
__device__ __forceinline__ void panel_stage(float* S, int P, int p, bool on,
                                            const Val& val) {
  const int t = threadIdx.x, q = t >> 6, c = t & (DN_WIDE_TC - 1);
  const int i0 = P * DN_PANEL_ROWS + q * 32;
  float* Sc = S + c * DN_PANEL_LD + q * 32;
#pragma unroll 2
  for (int k4 = 0; k4 < 32; k4 += 4) {
    float x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + k4 + j;
      x[j] = (on && i < p) ? val(i) : 0.f;
    }
    wide_st<4>(Sc + k4, x);
  }
}

// The Gram of the n "columns" l < n with on(l) of val(l, i) into M (p x p):
// each panel pair I <= J one pass over the columns in tiles, stored with its
// mirror.  ROWSUM: thread t < 128 also sums row I * 128 + t of the diagonal
// passes over the tiles' columns in order, into rowsum.  Ends with a barrier
// (M visible).
template <bool ROWSUM, class On, class Val>
__device__ __forceinline__ void panel_gram(PanelWork& w, WideGram<128>& g,
                                           int n, float* M, const On& on_fn,
                                           const Val& val,
                                           float* rowsum = nullptr) {
  constexpr int TC = DN_WIDE_TC, LD = DN_PANEL_LD, R = 8;
  const int t = threadIdx.x, c = t & (TC - 1), p = w.p;
  for (int I = 0; I < w.T; ++I) {
    for (int J = I; J < w.T; ++J) {
      g.zero();
      float rs = 0.f;
      for (int l0 = 0; l0 < n; l0 += TC) {
        const int l = l0 + c;
        const bool on = l < n && on_fn(l);
        panel_stage(w.SI, I, p, on, [&](int i) { return val(l, i); });
        if (J != I)
          panel_stage(w.SJ, J, p, on, [&](int i) { return val(l, i); });
        if (__syncthreads_or(on)) {  // a tile with no active column adds 0
          if (ROWSUM && J == I && t < DN_PANEL_ROWS)
            for (int k = 0; k < TC; ++k) rs += w.SI[k * LD + t];
          g.syrk2<LD>(w.SI, J != I ? w.SJ : w.SI, TC);
        }
        __syncthreads();  // S is read before the next tile writes it
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = I * DN_PANEL_ROWS + g.ty * R + r;
#pragma unroll
        for (int s = 0; s < R; ++s) {
          const int col = J * DN_PANEL_ROWS + g.tx * R + s;
          if (row < p && col < p) {
            M[(size_t)row * p + col] = g.acc[r][s];
            if (J != I) M[(size_t)col * p + row] = g.acc[r][s];
          }
        }
      }
      if (ROWSUM && J == I && t < DN_PANEL_ROWS &&
          I * DN_PANEL_ROWS + t < p)
        rowsum[I * DN_PANEL_ROWS + t] = rs;
    }
  }
  __syncthreads();
}

// y = (scale M) x over p rows, M symmetric (p x p, visible): thread i sums
// column i (= row i) in order of j, coalesced across the threads.  Ends
// with a barrier: y is visible.
__device__ __forceinline__ void panel_matvec(const PanelWork& w,
                                             const float* M, float scale,
                                             const float* x, float* y) {
  const int p = w.p;
  for (int i = threadIdx.x; i < p; i += DN_WIDE_THREADS) {
    float v = 0.f;
#pragma unroll 4
    for (int j = 0; j < p; ++j)
      v = fmaf(M[(size_t)j * p + i] * scale, x[j], v);
    y[i] = v;
  }
  __syncthreads();
}

// u = wv / |wv|, keeping u where the update collapsed; wv visible.  Ends
// with a barrier.
__device__ __forceinline__ void panel_renormalize(PanelWork& w,
                                                  const float* wv, float* u) {
  float n2 = 0.f;
  for (int j = threadIdx.x; j < w.p; j += DN_WIDE_THREADS)
    n2 = fmaf(wv[j], wv[j], n2);
  const float nrm = sqrtf(panel_sum(w.red, n2));
  if (nrm > DN_EPS)
    for (int i = threadIdx.x; i < w.p; i += DN_WIDE_THREADS)
      u[i] = wv[i] / (nrm + DN_EPS);
  __syncthreads();
}

// The power step on the gene's Gram in w.B (visible), from w.u to the refit
// w.u, as wide.cuh's wide_refit: n_plain > 0 plain matvecs on the
// normalised Gram and one normalisation, else the squared scheme (B^2 of
// the normalised Gram into w.B2, max(1, n_squared / 4) bodies of two B^2
// applications); with `finish`, s = sqrt(max(u^T B u, 0)) too.  The
// register tile `g` is overwritten.  Every thread returns the same s.
__device__ __forceinline__ void panel_refit(PanelWork& w, WideGram<128>& g,
                                            int n_squared, int n_plain,
                                            bool finish, float& s) {
  const int p = w.p;
  float m = 0.f;
  for (size_t k = threadIdx.x; k < (size_t)p * p; k += DN_WIDE_THREADS)
    m = fmaxf(m, fabsf(w.B[k]));
  const float inv = 1.0f / (panel_max(w.red, m) + DN_EPS);
  if (n_plain > 0) {
    const float* x = w.u;
    for (int it = 0; it < n_plain; ++it) {
      float* y = (it & 1) ? w.vb : w.va;
      panel_matvec(w, w.B, inv, x, y);
      x = y;
    }
    panel_renormalize(w, x, w.u);
  } else {
    // Bn Bn = sum_k Bn[k] Bn[k]^T over B's rows k, by the panel pairs (B
    // is exactly symmetric: row k read as column k, coalesced)
    const float* Bm = w.B;
    panel_gram<false>(
        w, g, p, w.B2, [](int) { return true; },
        [&](int k, int i) { return Bm[(size_t)i * p + k] * inv; });
    int n_bodies = n_squared / 4;
    if (n_bodies < 1) n_bodies = 1;
    for (int it = 0; it < n_bodies; ++it) {
      panel_matvec(w, w.B2, 1.f, w.u, w.va);
      panel_matvec(w, w.B2, 1.f, w.va, w.vb);
      panel_renormalize(w, w.vb, w.u);
    }
  }
  if (finish) {
    panel_matvec(w, w.B, 1.f, w.u, w.vc);
    float ubu = 0.f;
    for (int j = threadIdx.x; j < p; j += DN_WIDE_THREADS)
      ubu = fmaf(w.u[j], w.vc[j], ubu);
    s = sqrtf(fmaxf(panel_sum(w.red, ubu), 0.f));
  }
}

// v_c = sum_i X[i, l] u_i for this thread's column l of a tile: its rows
// (q * 32 + j of every panel) in order, then the four quarters' partials in
// a fixed order through w.vpart.  Returns whether the tile has an active
// column (the same in every thread); v is valid where `on`.  The caller
// ends a tile that has one with a barrier (vpart is read before the next
// tile writes it).
template <class Src>
__device__ __forceinline__ bool panel_v(const Src& src, PanelWork& w, int l,
                                        bool on, float& v) {
  constexpr int TC = DN_WIDE_TC;
  const int t = threadIdx.x, q = t >> 6, c = t & (TC - 1), p = w.p;
  float vp = 0.f;
  if (on) {
    for (int P = 0; P < w.T; ++P) {
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {
        const int i = P * DN_PANEL_ROWS + q * 32 + j;
        if (i < p) vp = fmaf(src.x(l, i), w.u[i], vp);
      }
    }
  }
  w.vpart[q * TC + c] = vp;
  // (a tile with no active column reads no partial: its caller goes on to
  // the next tile without a barrier)
  const bool any = __syncthreads_or(on);
  if (any)
    v = ((w.vpart[c] + w.vpart[TC + c]) + w.vpart[2 * TC + c]) +
        w.vpart[3 * TC + c];
  return any;
}

// The whole Lagrangian NMF-OA loop of one gene by a block of
// DN_WIDE_THREADS threads, as wide.cuh's wide_core (its ADAPT and from_x
// branches and results); u starts in w.u (visible, zero beyond p) and comes
// back refit there.  `src` as wide_core's.  Returns this thread's share of
// sum_w E[w].
template <bool ADAPT, class Src>
__device__ __forceinline__ float panel_core(const Src& src, PanelWork& w,
                                            float& s, int nmf_iter,
                                            int power_cold, int power_warm,
                                            int warm_plain, float tol = 0.f,
                                            int* n_run = nullptr,
                                            bool from_x = false) {
  constexpr int TC = DN_WIDE_TC;
  const int t = threadIdx.x, q = t >> 6, c = t & (TC - 1), p = w.p;
  const int nloc = src.n_local();
  const float step =
      nmf_iter > 0 ? (float)(1.0 / sqrt((double)nmf_iter)) : 0.f;
  WideGram<128> g;
  const auto on_fn = [&](int l) { return src.on(l); };
  const auto xval = [&](int l, int i) { return src.x(l, i); };
  s = 0.f;

  // cold: X = A0 (unless the X held is the start), then the Gram of X
  if (!from_x) {
    for (int l0 = 0; l0 < nloc; l0 += TC) {
      const int l = l0 + c;
      if (src.on(l))
        for (int i = q; i < p; i += 4) src.set_x(l, i, src.a0(l, i));
    }
    __syncthreads();
  }
  panel_gram<false>(w, g, nloc, w.B, on_fn, xval);
  panel_refit(w, g, power_cold, 0, ADAPT || nmf_iter == 0, s);

  int ran = nmf_iter;
  for (int it = 0; it < nmf_iter; ++it) {
    // v = u^T X and the multiplier update, a tile at a time
    for (int l0 = 0; l0 < nloc; l0 += TC) {
      const int l = l0 + c;
      const bool on = src.on(l);
      float v = 0.f;
      if (!panel_v(src, w, l, on, v)) continue;
      if (on) {  // a column outside the mask stays exactly zero
        const float se = ADAPT ? __fmul_rn(s, v / (s + DN_EPS)) : v;
        for (int P = 0; P < w.T; ++P) {
#pragma unroll 4
          for (int j = 0; j < 32; ++j) {
            const int i = P * DN_PANEL_ROWS + q * 32 + j;
            if (i < p) {
              const float a = src.a0(l, i);
              const float x = src.x(l, i);
              src.set_x(l, i, fmaxf(x - step * (w.u[i] * se - a), a));
            }
          }
        }
      }
      __syncthreads();  // vpart is read before the next tile writes it
    }
    __syncthreads();
    panel_gram<false>(w, g, nloc, w.B, on_fn, xval);
    if constexpr (ADAPT) {
      const float s_old = s;
      for (int i = t; i < w.np; i += DN_WIDE_THREADS) w.uo[i] = w.u[i];
      __syncthreads();
      panel_refit(w, g, power_warm, warm_plain, true, s);
      float delta = 0.f, ref = 0.f;
      for (int j = t; j < p; j += DN_WIDE_THREADS) {
        const float k_new = __fmul_rn(w.u[j], s);
        delta = fmaxf(delta, fabsf(k_new - __fmul_rn(w.uo[j], s_old)));
        ref = fmaxf(ref, fabsf(k_new));
      }
      delta = panel_max(w.red, delta);
      ref = fmaxf(panel_max(w.red, ref), DN_EPS);
      if (delta <= __fmul_rn(tol, ref)) {  // frozen: this update kept
        ran = it + 1;
        break;
      }
    } else {
      panel_refit(w, g, power_warm, warm_plain, it == nmf_iter - 1, s);
    }
  }
  if (n_run != nullptr) *n_run = ran;

  // finish: E = X^T u / (s + eps), and this thread's share of its sum
  float se = 0.f;
  for (int l0 = 0; l0 < nloc; l0 += TC) {
    const int l = l0 + c;
    const bool on = src.on(l);
    float v = 0.f;
    panel_v(src, w, l, on, v);
    if (q == 0) {
      const float e = on ? v / (s + DN_EPS) : 0.f;
      src.store_e(l, e);
      se += e;
    }
    __syncthreads();
  }
  return se;
}

// Launch of a panel kernel: at most `slots` blocks (each has its slot of
// the workspace), one an SM at most, each working through genes
// blockIdx.x, + gridDim.x, ...; `smem_extra` floats of dynamic shared
// memory beyond the core's.  Returns the CUDA error, 0 on success.
template <class Kern, class... Args>
int launch_panel(Kern kern, int G, int slots, size_t smem_extra,
                 cudaStream_t st, Args... args) {
  if (slots < 1) return (int)cudaErrorInvalidValue;
  if (G == 0) return 0;
  const size_t dyn = sizeof(float) * (panel_smem_floats() + smem_extra);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (e != cudaSuccess) return (int)e;
  const int grid = G < slots ? G : slots;
  kern<<<grid, DN_WIDE_THREADS, dyn, st>>>(args...);
  return (int)cudaGetLastError();
}
