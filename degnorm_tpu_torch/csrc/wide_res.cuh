// The resident core of kernels 1 and 3 for 33 <= p <= 128 samples (sm_90a):
// the Lagrangian NMF-OA loop of one gene with the gene's X held in shared
// memory for the whole loop (kernel 3: for every trim round), over one
// block or a cluster of blocks a gene, and the p x p Gram of every sweep on
// the tensor cores at float32 accuracy (3xTF32).
//
// Replaces, for the resident wide buckets (p * W <= 65,536, W <= 8192),
// wide.cuh's synchronous sweep (wide_sweep_sync with its register tile
// WideGram), whose kernels 1 and 3 it serves; the same TPU code as wide.cuh:
// degnorm_tpu/ops/pallas_nmf.py (_gram, _power, _power_warm, _nmf_loop),
// used by ops/pallas_nmf.py::nmf_masked_pallas and ops/pallas_trim.py::
// trim_loop_pallas.  wide.cuh's sweeps stay as they are for kernels 2 and 4
// and the panel instances.
//
// What bounds it on this card: the Gram's p(p+1)/2 products a column a
// sweep, three TF32 tensor-core products each (495 TFLOP/s dense), and the
// A0 of every active column read once a sweep (4p bytes a column, from L2:
// a gene's coverage stays there while its block works on it); X itself
// never leaves the chip inside the loop.  The layout:
//   * slots: the gene's active columns (kernel 3: those of its first
//     round's surviving bins; later rounds mask dropped bins' slots to
//     zero) are dealt in order to the cl blocks of its cluster, n / cl each
//     (res_deal); a block's slot j holds column scol[j], its X in shared
//     memory as PMAX rows of ldc floats, [row][slot], rows p.. and the slots
//     past the block's last up to a multiple of 8 zero.  ldc is 8 more than
//     a multiple of 32, so that the Gram's 8-byte fragment loads are free of
//     bank conflicts;
//   * a sweep (res_sweep) goes over the block's slots in chunks of 64: the
//     A0 of chunk k + 1 is loaded into registers while the Gram's products
//     of chunk k run, then chunk k + 1 is updated (v = u^T X over its rows
//     in order, the four quarters of a slot's rows in one warp summed by a
//     fixed butterfly, then x <- max(x - step (u v - a), a)), one barrier a
//     chunk; plain float32, fixed order;
//   * the Gram (res_gram_mma): mma.sync m16n8k8 TF32, each value split in
//     registers into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna's rounding,
//     done in integer arithmetic: dn_tf32) and
//     lo hi + hi lo + hi hi accumulated in float32 (the lo lo term, about
//     2^-22 of a product, is dropped).  The upper triangle only, T (T + 1)
//     fragments of 16 x 8 (T = PMAX / 16 row blocks of 16), dealt in turn
//     to the four warps of each of two K groups (the 8-slot steps k = grp,
//     grp + 2, ...); every warp splits all T row blocks of a step once and
//     takes the three products of its fragments from them, and the two
//     groups' partials are summed into B in group order.  Within a
//     step, physical slots 2t and 2t + 1 of thread t stand for the k = t and
//     k = t + 4 of both operands (one 8-byte load a row), which permutes the
//     sum over the slots and changes nothing else.  A diagonal block's
//     entries below the diagonal are not stored: B is written from i <= j
//     only and mirrored, so it is exactly symmetric;
//   * a cluster sums its blocks' B in rank order through distributed shared
//     memory (res_gram_reduce) and every block runs wide.cuh's power step
//     (wide_refit) on the same sum, so u and every decision of the loop are
//     bit-equal across the cluster and over two runs.
// The geometry (blocks a gene, the slots a block holds, its shared memory)
// is the dn_res_* functions below, mirrored by ops/cuda_nmf.py::
// res_geometry: a block holds at most capmax slots (what its shared memory
// fits at the bucket's W), and a gene of n active columns takes the fewest
// blocks whose equal shares fit, ceil(n / capmax); a bucket is launched
// once a cluster size its widest gene may need, each launch running its
// own genes.  A gene's blocks, and so its bits, depend on its own columns
// alone, not on the other genes of its bucket.
#pragma once

#include <cooperative_groups.h>

#include "wide.cuh"

namespace cg = cooperative_groups;

#define DN_RES_MAX_CLUSTER 3
#define DN_SMEM_BLOCK 232448  // bytes of shared memory a block may use

// The PMAX instances of kernels 1 and 3 that run this core (the others keep
// wide.cuh's synchronous sweep): a compile-time rule from the A/B of both
// cores in one call on the card (tools/wide_core_ab.py, PERF.md).  At PMAX
// 96 and 128 this core measured slower in 3aw and 3bw (96) and in every
// instance (128), and spilled registers.
template <int PMAX>
__host__ __device__ constexpr bool dn_res_on() {
  return PMAX <= 64;
}

// floats a row of X at cap slots (a multiple of 8): up to 8 more than a
// multiple of 32
__host__ __device__ constexpr int dn_res_ldc(int cap) {
  return cap + ((8 - cap % 32) % 32 + 32) % 32;
}
// bytes of a block's static shared memory, at most (kernel 3's loop state)
__host__ __device__ constexpr int dn_res_static_bytes(int pmax) {
  return 16 * pmax + 1024;
}
// floats of the work space before the slot tables: X, B, five p-vectors, 32
// of reduction scratch, 8 of cluster scratch, the W residual scores of
// kernel 3 (rounded up to 4)
__host__ __device__ constexpr int dn_res_floats(int pmax, int W, int cap) {
  return pmax * dn_res_ldc(cap) + pmax * (pmax + 4) + 5 * pmax + 40 +
         (W + 3) / 4 * 4;
}
// bytes of a block's dynamic shared memory at cap slots: the floats, then
// the slots' columns (uint16) and bins (uint8), each rounded up to 16 bytes
__host__ __device__ constexpr int dn_res_dyn_bytes(int pmax, int W, int cap) {
  return 4 * dn_res_floats(pmax, W, cap) + (2 * cap + 15) / 16 * 16 +
         (cap + 15) / 16 * 16;
}
// the most slots a block holds at (pmax, W), a multiple of 8 (no more than
// W rounded up); 0 where not even 8 fit
__host__ __device__ constexpr int dn_res_capmax(int pmax, int W) {
  int cap = (W + 7) / 8 * 8;
  while (cap > 0 && dn_res_dyn_bytes(pmax, W, cap) +
                            dn_res_static_bytes(pmax) >
                        DN_SMEM_BLOCK)
    cap -= 8;
  return cap;
}
// blocks of the cluster of a gene of n active columns: the fewest whose
// equal shares fit capmax slots each
__host__ __device__ constexpr int dn_res_gene_cluster(int n, int capmax) {
  return n <= capmax ? 1 : (n + capmax - 1) / capmax;
}
// the slots a block of the launch of clusters of cl holds at (W, capmax):
// the share of a gene of all W columns, at most capmax
__host__ __device__ constexpr int dn_res_cap(int W, int cl, int capmax) {
  const int c = ((W + cl - 1) / cl + 7) / 8 * 8;
  return c < capmax ? c : capmax;
}

template <int PMAX>
struct ResWork {
  WideWork<PMAX> ww;  // B, u, va, vb, vc, uo, red: wide.cuh's power step
  float* X;           // PMAX x ldc: the block's slots, [row][slot]
  float* cs;          // 8: the cluster's sums
  float* res;         // W: kernel 3's residual scores
  uint16_t* scol;     // cap: the column of each slot
  uint8_t* sbin;      // cap: its trim bin (kernel 3)
  int ldc, cap, n;    // row stride of X, slots a block may hold, held
  int cl, rank;       // blocks of the gene's cluster, this block's rank

  __device__ __forceinline__ void init(float* base, int W, int cap_, int cl_,
                                       int rank_) {
    cl = cl_;
    rank = rank_;
    cap = cap_;
    ldc = dn_res_ldc(cap);
    n = 0;
    X = base;
    ww.B = X + PMAX * ldc;
    ww.u = ww.B + PMAX * WideShape<PMAX>::LD;
    ww.va = ww.u + PMAX;
    ww.vb = ww.va + PMAX;
    ww.vc = ww.vb + PMAX;
    ww.uo = ww.vc + PMAX;
    ww.red = ww.uo + PMAX;
    cs = ww.red + 32;
    res = cs + 8;
    scol = (uint16_t*)(res + (W + 3) / 4 * 4);
    sbin = (uint8_t*)scol + (2 * cap + 15) / 16 * 16;
    ww.S = ww.S1 = ww.vpart = ww.stx = ww.sta = nullptr;
    ww.flag = nullptr;
  }
};

// The block's share of the gene's columns w < W with on_col(w), in column
// order: of the n such columns, numbers n rank / cl .. n (rank + 1) / cl - 1
// (the same n in every block of the cluster); bid: the columns' trim bins
// (kernel 3) or null.  Zeroes X's rows p.. and its slots past the block's
// last up to a multiple of 8.  Ends with a barrier.
template <int PMAX, class OnCol>
__device__ __forceinline__ void res_deal(ResWork<PMAX>& r, int p, int W,
                                         OnCol on_col, const int* bid) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int CH = (W + DN_WIDE_THREADS - 1) / DN_WIDE_THREADS;
  const int w0 = t * CH;
  int cnt = 0;
  for (int k = 0; k < CH; ++k) {
    const int w = w0 + k;
    if (w < W && on_col(w)) ++cnt;
  }
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(DN_FULL, incl, o);
    if (lane >= o) incl += y;
  }
  int* ws = (int*)r.ww.red;
  __syncthreads();  // red may be in use
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  int off = 0, tot = 0;
#pragma unroll
  for (int k = 0; k < DN_WIDE_THREADS / 32; ++k) {
    const int v = ws[k];
    if (k < warp) off += v;
    tot += v;
  }
  const int lo = (int)((long long)tot * r.rank / r.cl);
  const int hi = (int)((long long)tot * (r.rank + 1) / r.cl);
  int pos = off + incl - cnt;
  for (int k = 0; k < CH; ++k) {
    const int w = w0 + k;
    if (w < W && on_col(w)) {
      if (pos >= lo && pos < hi) {
        r.scol[pos - lo] = (uint16_t)w;
        if (bid != nullptr) r.sbin[pos - lo] = (uint8_t)bid[w];
      }
      ++pos;
    }
  }
  r.n = hi - lo;
  const int n8 = (r.n + 7) / 8 * 8;
  for (int e = t; e < PMAX * n8; e += DN_WIDE_THREADS) {
    const int i = e / n8, j = e % n8;
    if (i >= p || j >= r.n) r.X[i * r.ldc + j] = 0.f;
  }
  __syncthreads();  // ws is read before red's next use; scol visible
}

// v = u^T X of slots j and j + 1 (xj = X + j), each by its rows in order.
template <int PMAX>
__device__ __forceinline__ float2 res_v2(const float* xj, const float* u,
                                         int p, int ldc) {
  float2 v = make_float2(0.f, 0.f);
#pragma unroll 2
  for (int i0 = 0; i0 < p; i0 += 4) {
    const float4 u4 = *(const float4*)(u + i0);  // (zero beyond p)
    const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (i0 + q < p) {
        const float2 x = *(const float2*)(xj + (i0 + q) * ldc);
        v.x = fmaf(x.x, uu[q], v.x);
        v.y = fmaf(x.y, uu[q], v.y);
      }
    }
  }
  return v;
}

// ---- the Gram on the tensor cores -----------------------------------------

// x rounded to TF32 (10 mantissa bits) by nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds finite values: half a unit of the 13 dropped bits
// added to the magnitude, then the bits dropped.  In integer arithmetic on
// the full-rate ALU: the conversion instruction's pipe has a fraction of
// its rate, and the split takes two of them for every value of every step.
__device__ __forceinline__ uint32_t dn_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// c += a b (m16n8k8, TF32 in, float32 accumulate)
__device__ __forceinline__ void dn_mma_tf32(float (&c)[4], const uint32_t a0,
                                            const uint32_t a1,
                                            const uint32_t a2,
                                            const uint32_t a3,
                                            const uint32_t b0,
                                            const uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The split of warps: NKG = 2 groups of WPG = 4 over the 8-slot steps
// (group g the steps g, g + 2, ...; warps w and w + 4 share a scheduler, one
// of each group), the upper triangle's U = T (T + 1) fragments of 16 x 8
// (T = PMAX / 16 row blocks) dealt to a group's warps in turn, NU a warp
// at most.
template <int PMAX>
struct ResMma {
  static constexpr int T = PMAX / 16;
  static constexpr int WPG = 4;
  static constexpr int NKG = DN_WIDE_THREADS / 32 / WPG;
  static constexpr int U = T * (T + 1);
  static constexpr int NU = (U + WPG - 1) / WPG;
  // steps a warp takes together where the registers allow (their loads,
  // splits and products in flight at once; at PMAX 64 the second step's
  // registers spilled beside two chunks of A0)
  static constexpr int KU = T <= 3 ? 2 : 1;
  static_assert(PMAX % 16 == 0, "PMAX: 48, 64, 96 or 128");
};

// Fragment u of warp WIG of a group: the fragment f = WIG + u WPG of the
// triangle, strips c = 0 .. 2T-1 in order and in each the row blocks
// 0 .. c / 2; its row block (want_c false) or its strip, -1 past the last.
template <int PMAX, int WIG>
__host__ __device__ constexpr int res_unit(int u, bool want_c) {
  using M = ResMma<PMAX>;
  int f = WIG + u * M::WPG;
  for (int c = 0; c < 2 * M::T; ++c) {
    if (f <= c / 2) return want_c ? c : f;
    f -= c / 2 + 1;
  }
  return -1;
}

// A warp's fragments of the Gram over its group's steps kb + grp, kb + grp
// + NKG, ... below ke, added to acc (NU fragments of 16 x 8 for each of the
// KU steps taken together: independent chains of products).
template <int PMAX, int WIG>
__device__ __forceinline__ void res_gram_mma(
    const ResWork<PMAX>& r, int grp,
    float (&acc)[ResMma<PMAX>::KU][ResMma<PMAX>::NU][4], int kb, int ke) {
  using M = ResMma<PMAX>;
  constexpr int T = M::T, NU = M::NU, KU = M::KU;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int ldc = r.ldc;
  const float* xb = r.X + g * ldc + 2 * t4;
  for (int k0 = kb + grp; k0 < ke; k0 += KU * M::NKG) {
    uint32_t hi[KU][T][4], lo[KU][T][4];
#pragma unroll
    for (int ku = 0; ku < KU; ++ku) {
      const int kk = k0 + ku * M::NKG;
      // past the last step: zeros (a step of the zero padding's products)
      const float* xk = xb + (kk < ke ? kk : kb) * 8;
#pragma unroll
      for (int I = 0; I < T; ++I) {
        // rows 16 I + g and + 8, slots 2 t4 and 2 t4 + 1 of the step: the
        // A fragment's (a0, a2) and (a1, a3)
        float2 x0 = *(const float2*)(xk + 16 * I * ldc);
        float2 x1 = *(const float2*)(xk + (16 * I + 8) * ldc);
        if (kk >= ke) x0 = x1 = make_float2(0.f, 0.f);
        const float v[4] = {x0.x, x1.x, x0.y, x1.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hi[ku][I][e] = dn_tf32(v[e]);
          lo[ku][I][e] = dn_tf32(v[e] - __uint_as_float(hi[ku][I][e]));
        }
      }
    }
    // the three products of every fragment, one term over all fragments
    // at a time (consecutive products are independent), the small terms
    // first; the B fragment of strip c is rows 8 c + g of the step, the
    // half h of row block J's A fragment
#pragma unroll
    for (int ku = 0; ku < KU; ++ku)
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          const int I = res_unit<PMAX, WIG>(u, false);
          const int c = res_unit<PMAX, WIG>(u, true);
          if (I < 0) continue;
          const int J = c / 2, h = c % 2;
          const uint32_t(&a)[4] = term == 0 ? lo[ku][I] : hi[ku][I];
          const uint32_t(&b)[4] = term == 1 ? lo[ku][J] : hi[ku][J];
          dn_mma_tf32(acc[ku][u], a[0], a[1], a[2], a[3], b[h], b[2 + h]);
        }
  }
}

// A warp's fragments into B.  Every group but the last stores (group 0) or
// adds its partial at the fragments' own places (each (warp, lane) of a
// group holds the same entries), reading all before writing any; the last
// group adds and writes the upper triangle's entries (i <= j) and their
// mirrors.
template <int PMAX, int WIG>
__device__ __forceinline__ void res_gram_store(
    const ResWork<PMAX>& r,
    const float (&acc)[ResMma<PMAX>::KU][ResMma<PMAX>::NU][4], bool first,
    bool last) {
  using M = ResMma<PMAX>;
  constexpr int NU = M::NU, LD = WideShape<PMAX>::LD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  float* B = r.ww.B;
  float v[NU][4];
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int I = res_unit<PMAX, WIG>(u, false);
    const int c = res_unit<PMAX, WIG>(u, true);
    if (I < 0) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 16 * I + g + 8 * h, j = 8 * c + 2 * t4;
      float2 b = make_float2(0.f, 0.f);
      if (!first) b = *(const float2*)(B + i * LD + j);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float a = acc[0][u][2 * h + k];
#pragma unroll
        for (int ku = 1; ku < M::KU; ++ku) a += acc[ku][u][2 * h + k];
        v[u][2 * h + k] = a + (k ? b.y : b.x);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int I = res_unit<PMAX, WIG>(u, false);
    const int c = res_unit<PMAX, WIG>(u, true);
    if (I < 0) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 16 * I + g + 8 * h, j = 8 * c + 2 * t4;
      if (!last) {
        *(float2*)(B + i * LD + j) = make_float2(v[u][2 * h], v[u][2 * h + 1]);
        continue;
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (i <= j + k) {
          B[i * LD + j + k] = v[u][2 * h + k];
          B[(j + k) * LD + i] = v[u][2 * h + k];
        }
      }
    }
  }
}

// B = the Gram of the cluster's X (every block the same bits), exactly
// symmetric and visible, from the warps' fragments of the block's Gram
// (acc): the K groups' partials summed into B in group order, the last
// writing the mirror.  A cluster of several then sums its blocks' B
// through distributed shared memory: rank q takes rows PMAX q / cl ..
// PMAX (q + 1) / cl - 1, sums them over the ranks in rank order (the
// mirrored partials give the mirrored sums, bit for bit) and writes the
// sums into every block's B; no block reads those rows of another but rank
// q.  Two cluster barriers.
template <int PMAX>
__device__ __forceinline__ void res_gram_reduce(
    const ResWork<PMAX>& r,
    const float (&acc)[ResMma<PMAX>::KU][ResMma<PMAX>::NU][4]) {
  using M = ResMma<PMAX>;
  constexpr int LD = WideShape<PMAX>::LD, C4 = PMAX / 4;
  const int t = threadIdx.x, warp = t >> 5;
  const int grp = warp / M::WPG, wig = warp % M::WPG;
  // (a branch a warp: each instance indexes its registers by constants)
  for (int gg = 0; gg < M::NKG; ++gg) {
    if (grp == gg) {
      const bool first = gg == 0, last = gg == M::NKG - 1;
      if (wig == 0) res_gram_store<PMAX, 0>(r, acc, first, last);
      if (wig == 1) res_gram_store<PMAX, 1>(r, acc, first, last);
      if (wig == 2) res_gram_store<PMAX, 2>(r, acc, first, last);
      if (wig == 3) res_gram_store<PMAX, 3>(r, acc, first, last);
    }
    __syncthreads();
  }
  if (r.cl == 1) return;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  float* Bq[DN_RES_MAX_CLUSTER];
  for (int q = 0; q < r.cl; ++q) Bq[q] = cluster.map_shared_rank(r.ww.B, q);
  const int i0 = PMAX * r.rank / r.cl, i1 = PMAX * (r.rank + 1) / r.cl;
  const int items = (i1 - i0) * C4;
  constexpr int NB = 4;  // float4s a thread has in flight
  for (int e0 = t; e0 < items; e0 += NB * DN_WIDE_THREADS) {
    float4 part[NB][DN_RES_MAX_CLUSTER];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int e = e0 + b * DN_WIDE_THREADS;
      const int off = (i0 + e / C4) * LD + 4 * (e % C4);
#pragma unroll
      for (int q = 0; q < DN_RES_MAX_CLUSTER; ++q)
        if (e < items && q < r.cl) part[b][q] = *(const float4*)(Bq[q] + off);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int e = e0 + b * DN_WIDE_THREADS;
      if (e >= items) continue;
      const int off = (i0 + e / C4) * LD + 4 * (e % C4);
      float4 s = part[b][0];
#pragma unroll
      for (int q = 1; q < DN_RES_MAX_CLUSTER; ++q) {
        if (q < r.cl) {
          s.x += part[b][q].x;
          s.y += part[b][q].y;
          s.z += part[b][q].z;
          s.w += part[b][q].w;
        }
      }
#pragma unroll
      for (int q = 0; q < DN_RES_MAX_CLUSTER; ++q)
        if (q < r.cl) *(float4*)(Bq[q] + off) = s;
    }
  }
  cluster.sync();  // every block's B holds the sums; none is read remotely
}

// One sweep over the block's slots, in chunks of 64 slots (8 steps of the
// Gram), software-pipelined: while the Gram's products of chunk k run,
// chunk k + 1 is updated and the A0 of chunk k + 2 (PMAX > 64: of chunk
// k + 1) is in flight; one barrier a chunk.  The cold sweep (MERGED false): X = A0 on the active slots
// (from_x: the X held stays), zero on the others; a merged one, on the
// active slots: v = u^T X, X <- max(X - step (u v - A0), A0) (an inactive
// slot's X is zero and stays so).  Thread (warp w, lane l) updates slot
// 8 w + l % 8 of a chunk, its rows q, q + 4, ... (q = l / 8: the four
// quarters of a slot in one warp, each quarter's rows on its own 8 banks),
// v summed over the quarters by a fixed butterfly.  F: the gene's (p, W)
// rows; on(j): slot j is active.  Ends with the Gram in B (res_gram_reduce).
template <int PMAX, bool ADAPT, bool MERGED, class On>
__device__ __forceinline__ void res_sweep(const ResWork<PMAX>& r,
                                          const float* __restrict__ F, int p,
                                          int W, float step, float s,
                                          bool from_x, On on) {
  using M = ResMma<PMAX>;
  constexpr int Q = PMAX / 4, CS = 64;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int grp = warp / M::WPG, wig = warp % M::WPG;
  const int cs = 8 * warp + (lane & 7), q = lane >> 3;
  const int n = r.n, ldc = r.ldc, nk8 = (n + 7) / 8;
  const int nch = (n + CS - 1) / CS;
  const float* u = r.ww.u;
  const bool load = MERGED || !from_x;
  float acc[M::KU][M::NU][4];
#pragma unroll
  for (int ku = 0; ku < M::KU; ++ku)
#pragma unroll
    for (int k = 0; k < M::NU; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ku][k][e] = 0.f;
  // this thread's rows of A0 of chunk kc's slot (zeros off it)
  const auto fetch = [&](int kc, float (&a)[Q]) {
    const int j = kc * CS + cs;
    const bool act = j < n && on(j) && load;
    const float* fw = F + (act ? r.scol[j] : 0);
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const int i = 4 * k + q;
      a[k] = (act && i < p) ? __ldg(fw + (size_t)i * W) : 0.f;
    }
  };
  const auto update = [&](int kc, const float (&a)[Q]) {
    const int j = kc * CS + cs;
    const bool act = j < n && on(j);
    float* xj = r.X + j;
    if constexpr (!MERGED) {
      if (j >= n || (act && from_x)) return;
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        const int i = 4 * k + q;
        if (i < p) xj[i * ldc] = a[k];
      }
    } else {
      // this thread's rows of u and of the slot's X into registers before
      // any store (the stores could alias the loads for all the compiler
      // knows); u is zero past p
      float uu[Q], x[Q];
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        const int i = 4 * k + q;
        uu[k] = u[i];
        x[k] = (act && i < p) ? xj[i * ldc] : 0.f;
      }
      float vp = 0.f;
#pragma unroll
      for (int k = 0; k < Q; ++k) vp = fmaf(x[k], uu[k], vp);
      const float v1 = vp + __shfl_xor_sync(DN_FULL, vp, 8);
      const float v = v1 + __shfl_xor_sync(DN_FULL, v1, 16);
      if (!act) return;
      // ADAPT: est = K_i E_w taken as u_i (s E_w), as nmf_core does
      const float se = ADAPT ? __fmul_rn(s, v / (s + DN_EPS)) : v;
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        const int i = 4 * k + q;
        if (i < p) xj[i * ldc] = fmaxf(x[k] - step * (uu[k] * se - a[k]), a[k]);
      }
    }
  };
  const auto gram = [&](int kc) {
    const int kb = kc * (CS / 8), ke = min(kb + CS / 8, nk8);
    // (a branch a warp: each instance indexes its registers by constants)
    if (wig == 0) res_gram_mma<PMAX, 0>(r, grp, acc, kb, ke);
    if (wig == 1) res_gram_mma<PMAX, 1>(r, grp, acc, kb, ke);
    if (wig == 2) res_gram_mma<PMAX, 2>(r, grp, acc, kb, ke);
    if (wig == 3) res_gram_mma<PMAX, 3>(r, grp, acc, kb, ke);
  };
  float a0[Q];
  if constexpr (PMAX > 64) {
    // (the registers of a second chunk's A0 spilled here): chunk k + 1's
    // loads are in flight through the products of chunk k
    fetch(0, a0);
    update(0, a0);
    __syncthreads();
    for (int kc = 0; kc < nch; ++kc) {
      if (kc + 1 < nch) fetch(kc + 1, a0);
      gram(kc);
      if (kc + 1 < nch) update(kc + 1, a0);
      __syncthreads();
    }
    res_gram_reduce<PMAX>(r, acc);
    return;
  }
  // A0 two chunks ahead: chunk k + 2's loads are in flight through the
  // products of chunk k and the update of chunk k + 1 (a0 holds the even
  // chunks', a1 the odd ones')
  float a1[Q];
  fetch(0, a0);
  if (nch > 1) fetch(1, a1);
  update(0, a0);
  __syncthreads();
  for (int kc = 0; kc < nch; kc += 2) {
    if (kc + 2 < nch) fetch(kc + 2, a0);
    gram(kc);
    if (kc + 1 < nch) update(kc + 1, a1);
    __syncthreads();
    if (kc + 1 >= nch) break;
    if (kc + 3 < nch) fetch(kc + 3, a1);
    gram(kc + 1);
    if (kc + 2 < nch) update(kc + 2, a0);
    __syncthreads();
  }
  res_gram_reduce<PMAX>(r, acc);
}

// The block's value v (the same in every thread) summed over the cluster in
// rank order; the same in every block.
template <int PMAX>
__device__ __forceinline__ float res_cluster_sum(const ResWork<PMAX>& r,
                                                 float v) {
  if (r.cl == 1) return v;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) r.cs[0] = v;
  cluster.sync();
  float tot = 0.f;
  for (int q = 0; q < r.cl; ++q) tot += *cluster.map_shared_rank(r.cs, q);
  cluster.sync();
  return tot;
}

// The whole Lagrangian NMF-OA loop of one gene on the block's slots (dealt
// by res_deal), as wide.cuh::wide_core, with its ADAPT and from_x branches
// and results: u starts in r.ww.u (visible, zero beyond p) and comes back
// refit there, identical in every block of the cluster; E is written for
// the block's active slots (its other columns are the caller's).  Returns
// this thread's share of the block's sum of E.
template <int PMAX, bool ADAPT, class On>
__device__ __forceinline__ float res_core(ResWork<PMAX>& r,
                                          const float* __restrict__ F,
                                          float* E, int p, int W, On on,
                                          float& s, int nmf_iter,
                                          int power_cold, int power_warm,
                                          int warm_plain, float tol = 0.f,
                                          int* n_run = nullptr,
                                          bool from_x = false) {
  const int t = threadIdx.x;
  const float step =
      nmf_iter > 0 ? (float)(1.0 / sqrt((double)nmf_iter)) : 0.f;
  WideGram<PMAX> g;  // the power step's register tile
  s = 0.f;

  // cold sweep: X = A0 (or the X held, from_x), Gram of X
  res_sweep<PMAX, ADAPT, false>(r, F, p, W, step, s, from_x, on);
  wide_refit<PMAX>(r.ww, g, power_cold, 0, ADAPT || nmf_iter == 0, s);

  // merged sweeps: v = u^T X, multiplier update, Gram of the new X
  int ran = nmf_iter;
  for (int it = 0; it < nmf_iter; ++it) {
    res_sweep<PMAX, ADAPT, true>(r, F, p, W, step, s, from_x, on);
    if constexpr (ADAPT) {
      const float s_old = s;
      if (t < PMAX) r.ww.uo[t] = r.ww.u[t];
      // (wide_refit's first barrier orders this copy before u changes)
      wide_refit<PMAX>(r.ww, g, power_warm, warm_plain, true, s);
      float delta = 0.f, ref = 0.f;
#pragma unroll 8
      for (int j = 0; j < PMAX; ++j) {
        const float k_new = __fmul_rn(r.ww.u[j], s);
        delta = fmaxf(delta, fabsf(k_new - __fmul_rn(r.ww.uo[j], s_old)));
        ref = fmaxf(ref, fabsf(k_new));
      }
      ref = fmaxf(ref, DN_EPS);
      if (delta <= __fmul_rn(tol, ref)) {  // frozen: this update kept
        ran = it + 1;
        break;
      }
    } else {
      wide_refit<PMAX>(r.ww, g, power_warm, warm_plain, it == nmf_iter - 1,
                       s);
    }
  }
  if (n_run != nullptr) *n_run = ran;

  // finish: E = X^T u / (s + eps) on the active slots
  float se = 0.f;
  for (int j = 2 * t; j < r.n; j += 2 * DN_WIDE_THREADS) {
    const bool act0 = on(j), act1 = j + 1 < r.n && on(j + 1);
    if (!act0 && !act1) continue;
    const float2 v = res_v2<PMAX>(r.X + j, r.ww.u, p, r.ldc);
    if (act0) {
      const float e = v.x / (s + DN_EPS);
      E[r.scol[j]] = e;
      se += e;
    }
    if (act1) {
      const float e = v.y / (s + DN_EPS);
      E[r.scol[j + 1]] = e;
      se += e;
    }
  }
  return se;
}

// Launches of a resident kernel over a bucket's G genes at (PMAX, W): one a
// cluster size cl = 1 .. dn_res_gene_cluster(W, capmax), each of G clusters
// of cl blocks with dn_res_cap(W, cl, capmax) slots a block; a cluster whose
// gene needs another size leaves at once (res_gene_runs).  The launches of
// clusters of two and three run on a stream of their own beside st's one,
// ordered after st's earlier work and before its later work by events, so
// that the launches overlap.  The kernel's last three arguments are cap,
// capmax and cl.  Returns a cudaError_t.
template <int PMAX, class Kern, class... Args>
int dn_res_launch(Kern kern, int G, int W, cudaStream_t st, Args... args) {
  const int capmax = dn_res_capmax(PMAX, W);
  if (capmax == 0) return (int)cudaErrorInvalidValue;
  const int ncl = dn_res_gene_cluster(W, capmax);
  if (ncl > DN_RES_MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  cudaStream_t side = st;
  cudaEvent_t fork = nullptr, join = nullptr;
  cudaError_t e = cudaSuccess;
  if (ncl > 1) {
    if ((e = cudaStreamCreateWithFlags(&side, cudaStreamNonBlocking)) ||
        (e = cudaEventCreateWithFlags(&fork, cudaEventDisableTiming)) ||
        (e = cudaEventCreateWithFlags(&join, cudaEventDisableTiming)) ||
        (e = cudaEventRecord(fork, st)) ||
        (e = cudaStreamWaitEvent(side, fork, 0)))
      return (int)e;
  }
  for (int cl = 1; cl <= ncl && e == cudaSuccess; ++cl) {
    const int cap = dn_res_cap(W, cl, capmax);
    const size_t dyn = (size_t)dn_res_dyn_bytes(PMAX, W, cap);
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dyn);
    if (e != cudaSuccess) break;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)G * cl, 1, 1);
    cfg.blockDim = dim3(DN_WIDE_THREADS, 1, 1);
    cfg.dynamicSmemBytes = dyn;
    cfg.stream = cl == 1 ? st : side;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cl;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kern, args..., cap, capmax, cl);
  }
  if (ncl > 1) {
    // (the stream and the events are released once their work is done)
    if (e == cudaSuccess) e = cudaEventRecord(join, side);
    if (e == cudaSuccess) e = cudaStreamWaitEvent(st, join, 0);
    cudaEventDestroy(fork);
    cudaEventDestroy(join);
    cudaStreamDestroy(side);
  }
  return (int)e;
}

// Whether this launch (clusters of cl) runs the gene whose columns w < W
// with on_col(w) it counts: the same answer in every block of the cluster.
// Ends with a barrier.
template <class OnCol>
__device__ __forceinline__ bool res_gene_runs(int W, int capmax, int cl,
                                              OnCol on_col, int* scratch) {
  int n = 0;
  for (int w = threadIdx.x; w < W; w += DN_WIDE_THREADS) n += on_col(w);
  n = __reduce_add_sync(DN_FULL, n);
  if (threadIdx.x == 0) *scratch = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) atomicAdd(scratch, n);
  __syncthreads();
  const int total = *scratch;
  __syncthreads();
  return dn_res_gene_cluster(total, capmax) == cl;
}
