"""The Lagrangian NMF-OA loop and the ratio-SVD row sums: CUDA kernel
wrappers and their plain PyTorch versions.

Counterpart of ``degnorm_tpu/ops/pallas_nmf.py`` (``nmf_masked_pallas`` and
``ratio_rowsums_pallas``).  Each wrapper takes its plain version only for a
tensor that lies on the CPU; for a CUDA tensor it launches the kernel
(``csrc/nmf.cu``, ``csrc/ratio.cuh``) or raises.  Each wrapper counts its
launches in a module-level int.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from degnorm_tpu_torch.core.linalg import (finish_rank_one, masked_rank_one,
                                           masked_rank_one_uv, outer_product)

# Launch counters (plain ints): one is added where a kernel is launched and
# nowhere else.  ``nmf_tol_launches`` counts the launches of kernel 1 that
# run its nmf_tol branch (they are in ``nmf_launches`` too).
nmf_launches = 0
nmf_tol_launches = 0
ratio_launches = 0
# the launches of the wide instances (NARROW_MAX_P < p <= WIDE_MAX_P:
# csrc/nmf_wide.cuh, csrc/ratio_wide.cuh) and of the panel instances (p >
# WIDE_MAX_P: csrc/nmf_panel.cu, csrc/ratio_panel.cu), in the counts above
# too
nmf_wide_launches = 0
nmf_wide_tol_launches = 0
ratio_wide_launches = 0
nmf_panel_launches = 0
nmf_panel_tol_launches = 0
ratio_panel_launches = 0
# ... of them, kernel 1's on its phased layout past PCL_MAX_P
# (``panel_phase(p, "nmf")``: both branches)
nmf_panel_phase_launches = 0
# ... of them, kernel 2's on its cluster layout (``panel_cluster(p,
# "stream")``) and on its phased layout past it (``panel_phase(p)``)
ratio_panel_cluster_launches = 0
ratio_panel_phase_launches = 0
# kernel 2c (the column-sharded ratio-SVD row sums): both of its launches;
# of them, those of its wide instances (NARROW_MAX_P < p <= COLS_MAX_P)
ratio_cols_launches = 0
ratio_cols_wide_launches = 0

# Shape gate of the resident loop kernels (kernel 1, the NMF loop, and
# kernel 3, the fused trim loop; ops/cuda_trim.py uses the same gate).  Each
# limit belongs to one need:
#   * p * W <= MAX_PW, kernels 1 and 3: one block owns one gene and keeps its
#     X in a global scratch, so a gene's X and coverage (2 * p * W * 4 bytes,
#     512 KB at the limit) must stay small enough that the blocks in flight
#     keep their working sets in the 50 MB L2 cache;
#   * W <= MAX_W, kernel 3 only: its per-column residual buffer (4 * W bytes)
#     lives in shared memory.
# No limit on p: kernels 1-4 take every p >= 2.  Kernel 2 (ratio-SVD row
# sums) has no scratch and no width-sized buffer: it takes any W
# (``check_coverage_input``).  A bucket outside the gate takes the cluster
# kernel of ops/cuda_stream.py for its NMF and the unfused trim loop.
# p above NARROW_MAX_P runs the wide instances of kernels 1-4
# (csrc/wide.cuh: the Gram in shared memory and the power step the block's,
# a block of WIDE_THREADS threads), p above WIDE_MAX_P their panel instance
# (csrc/panel.cuh: the Gram in row panels of PANEL_ROWS, on a cluster of
# blocks a gene for kernels 1 and 3 up to PCL_MAX_P and kernels 2 and 4 up
# to PCL_MAX_P_STREAM, ``panel_cluster``, past that on the phased layout,
# ``panel_phase``).  Kernels 4c and 2c, the column-sharded forms of kernels
# 4 and 2, have narrow instances (csrc/stream_cols.cuh) and, above
# NARROW_MAX_P, wide ones (csrc/stream_cols_wide.cuh) but no panel
# instance: they stop at COLS_MAX_P (= WIDE_MAX_P), and the engine
# gene-shards a wider bucket (``engine.DegNormEngine.column_sharded``).
NARROW_MAX_P = 32
WIDE_MAX_P = 128
PANEL_ROWS = 128
COLS_MAX_P = 128
MAX_W = 8192
MAX_PW = 65536
WIDE_THREADS = 256


# The resident core of the wide kernels 1 and 3 (csrc/wide_res.cuh, mirror
# of its dn_res_* functions): a gene's X held in the shared memory of a
# cluster of blocks for the whole loop, the Gram on the tensor cores.  A
# block holds at most ``res_capmax`` column slots (a multiple of 8) of PMAX
# rows; a gene of n active columns takes ``res_gene_cluster(n, capmax)``
# blocks; a bucket is launched once a cluster size up to its widest gene's
# (``res_geometry``).  RES_PMAX: the PMAX instances that run the core (the
# compile-time rule ``dn_res_on``; the others keep csrc/wide.cuh's
# synchronous sweep).
RES_PMAX = (48, 64)
RES_MAX_CLUSTER = 3
SMEM_BLOCK_BYTES = 232448       # shared memory a block of an H100 may use


def res_core(p: int) -> bool:
    """True where kernels 1 and 3 run p on the resident core."""
    return NARROW_MAX_P < p <= WIDE_MAX_P and pmax_of(p) in RES_PMAX


def res_ldc(cap: int) -> int:
    """Floats a row of a block's X at ``cap`` slots (``dn_res_ldc``): 8
    more than a multiple of 32, so that the Gram's 8-byte fragment loads
    miss no bank."""
    return cap + (8 - cap % 32) % 32


def res_smem_bytes(pmax: int, W: int, cap: int) -> int:
    """Shared memory of a block holding ``cap`` slots
    (``dn_res_dyn_bytes`` + ``dn_res_static_bytes``): X (pmax x ldc
    floats), B (pmax x (pmax + 4)), five pmax-vectors, 40 floats of
    scratch, kernel 3's W residual scores, the slots' columns (uint16) and
    bins (uint8), and at most 16 pmax + 1,024 bytes of kernel 3's static
    loop state."""
    floats = (pmax * res_ldc(cap) + pmax * (pmax + 4) + 5 * pmax + 40
              + (W + 3) // 4 * 4)
    return (4 * floats + (2 * cap + 15) // 16 * 16 + (cap + 15) // 16 * 16
            + 16 * pmax + 1024)


def res_capmax(pmax: int, W: int) -> int:
    """The most slots a block holds at (pmax, W) (``dn_res_capmax``): a
    multiple of 8, no more than W rounded up; 0 where not even 8 fit."""
    cap = (W + 7) // 8 * 8
    while cap > 0 and res_smem_bytes(pmax, W, cap) > SMEM_BLOCK_BYTES:
        cap -= 8
    return cap


def res_gene_cluster(n: int, capmax: int) -> int:
    """Blocks of the cluster of a gene of ``n`` active columns
    (``dn_res_gene_cluster``): the fewest whose equal shares fit."""
    return 1 if n <= capmax else -(-n // capmax)


def res_cap(W: int, cl: int, capmax: int) -> int:
    """Slots a block of the launch of clusters of ``cl`` holds
    (``dn_res_cap``): the share of a gene of all W columns, at most
    ``capmax``."""
    return min((-(-W // cl) + 7) // 8 * 8, capmax)


def res_geometry(p: int, W: int) -> Tuple[int, List[Tuple[int, int, int]]]:
    """(capmax, launches) of the resident core at a (p, W) bucket: the most
    slots a block holds, and for each cluster size cl = 1 .. the widest
    gene's, (cl, slots a block, bytes of shared memory a block).  A gene's
    blocks depend on its own active columns alone
    (``res_gene_cluster``), so its bits do not depend on the other genes of
    its bucket.  Raises outside the wide instances' p or where a gene of W
    columns would need more than RES_MAX_CLUSTER blocks."""
    if not NARROW_MAX_P < p <= WIDE_MAX_P:
        raise ValueError(f"res_geometry: p={p} is not a wide instance's")
    pmax = pmax_of(p)
    capmax = res_capmax(pmax, W)
    ncl = res_gene_cluster(W, capmax) if capmax else RES_MAX_CLUSTER + 1
    if ncl > RES_MAX_CLUSTER:
        raise ValueError(f"res_geometry: p={p}, W={W} needs more than "
                         f"{RES_MAX_CLUSTER} blocks a gene")
    return capmax, [(cl, res_cap(W, cl, capmax),
                     res_smem_bytes(pmax, W, res_cap(W, cl, capmax)))
                    for cl in range(1, ncl + 1)]


def kernels_supported(shape, dtype) -> bool:
    """True when a (G, p, W) bucket of this dtype is inside the gate of the
    resident loop kernels (kernels 1 and 3)."""
    _, p, W = shape
    return (dtype == torch.float32 and 2 <= p and W <= MAX_W
            and p * W <= MAX_PW)


def check_coverage_input(F: torch.Tensor, name: str, int16_ok: bool = False,
                         max_p: Optional[int] = None) -> None:
    """What every kernel needs of its coverage tensor (and all that kernel 2
    needs): float32 (or int16 where ``int16_ok``: kernels 2, 4, 4c and 2c
    read the raw upload), contiguous, p >= 2 and, where the kernel has a
    limit, p <= ``max_p`` (COLS_MAX_P for 4c and 2c; kernels 1-4 have
    none).  Raises; never falls back."""
    if F.dtype != torch.float32 and not (int16_ok and F.dtype == torch.int16):
        raise TypeError(f"{name}: the CUDA kernels are float32"
                        f"{' or int16' if int16_ok else ''}, got {F.dtype}")
    if not F.is_contiguous():
        raise ValueError(f"{name}: coverage tensor must be contiguous")
    p = F.shape[1]
    if p < 2 or (max_p is not None and p > max_p):
        raise ValueError(f"{name}: p={p} outside this kernel's range "
                         f"2..{max_p or ''}")


def check_kernel_input(F: torch.Tensor, name: str) -> None:
    """Raise on what the resident loop kernels do not take; never fall
    back."""
    check_coverage_input(F, name)
    _, p, W = F.shape
    if W > MAX_W or p * W > MAX_PW:
        raise NotImplementedError(
            f"{name}: bucket p={p}, W={W} is too wide for the resident "
            f"kernels (W <= {MAX_W}, p*W <= {MAX_PW}); such a bucket goes "
            "through the streamed kernel, ops/cuda_stream.py::"
            "nmf_masked_streamed_cuda (core/nmf.py routes by this gate)")


def max_loop_threads(p: int) -> int:
    """Most threads a block of kernels 1, 3 and 4 may have
    (``dn_max_warps`` of csrc/common.cuh): the p > 8 instances keep a Gram
    tile a warp in shared memory and more registers a thread."""
    return 512 if p <= 8 else 256


def pick_loop_threads(p: int, W: int) -> int:
    """Threads of a block of kernels 1 and 3 (one block per gene): a thread
    per 16 columns, in whole warps within the kernel's bound.  A sweep costs
    a reduction, a barrier and a power step a warp whatever its columns, so
    few warps a gene win while enough genes are in flight (the measurements:
    PERF.md, ``chip_smoke.py --sweep``).  A thread's column slots must fit
    the kernels' 64-bit mask of active slots, which any W inside the gate
    does.  p > NARROW_MAX_P: the wide instances' WIDE_THREADS, whatever W."""
    if p > NARROW_MAX_P:
        return WIDE_THREADS
    return min(max_loop_threads(p), max(32, (W // 16 + 31) // 32 * 32))


# The card the launch rules were measured on (``chip_smoke.py --sweep``):
# an H100's SMs.
SMS = 132


def pmax_of(p: int) -> int:
    """The rows the instance that runs p carries: its template instance
    up to WIDE_MAX_P (``DN_DISPATCH_P``, and ``DN_DISPATCH_WIDE_P`` of
    csrc/wide.cuh above NARROW_MAX_P); above it the panel instance, one for
    every p, whose rows are whole panels of PANEL_ROWS (``dn_panel_np`` of
    csrc/panel.cuh)."""
    for pm in (4, 8, 16, 32, 48, 64, 96, 128):
        if p <= pm:
            return pm
    return -(-p // PANEL_ROWS) * PANEL_ROWS


def instance_of(p: int) -> str:
    """The name of the instance that runs p in kernels 1-4: ``p<PMAX>`` up
    to NARROW_MAX_P, ``wide<PMAX>`` up to WIDE_MAX_P, ``panel`` above."""
    if p > WIDE_MAX_P:
        return "panel"
    return ("wide" if p > NARROW_MAX_P else "p") + str(pmax_of(p))


def panel_slots(G: int, device) -> int:
    """Genes a group of the phased layout holds, each with its slot of the
    workspace: one an SM of the card, fewer for fewer genes."""
    if device.type != "cuda":
        return min(G, SMS)
    return min(G, torch.cuda.get_device_properties(device).multi_processor_count)


# The kinds of kernel a workspace belongs to: kernel 1 ("nmf"), kernel 3
# ("loop": kernels 1 and 3 share its cluster layout's cut), kernels 2 and 4
# ("stream").
WORKSPACE_KINDS = ("nmf", "loop", "stream")


def workspace_kinds(p: int, widths, use_kernels: bool = True):
    """The kinds of kernel (WORKSPACE_KINDS) that a fit at p launches with
    buckets of ``widths``: kernels 2 ("stream") on every bucket, kernel 4
    on a bucket outside the resident gate, kernels 1 ("nmf") and 3
    ("loop") on one inside it; none with the kernels off."""
    if not use_kernels or not widths:
        return ()
    resident = any(W <= MAX_W and p * W <= MAX_PW for W in widths)
    return ("nmf", "loop", "stream") if resident else ("stream",)


def kind_workspace_floats(p: int, kind: str, sms: int, G: int,
                          widths=None) -> int:
    """Floats of the largest workspace a launch of ``kind`` takes at p on a
    card of ``sms`` SMs with a bucket of at most G genes
    (``kernel_workspace``): the phased layout's past the kind's cluster
    layout (kernel 3's with its trim state, ``trim_phase_floats``, at the
    widest resident width of ``widths``, None: the gate's MAX_PW // p), the
    cluster layout's where a block holds several pairs (none where it holds
    one); at NARROW_MAX_P < p <= WIDE_MAX_P kernel 2's wide
    instance (``ratio_wide_workspace``) at the largest of the buckets'
    ``widths`` (None: RW_WS_FLOATS, its cap where a slot fits); none at
    p <= NARROW_MAX_P."""
    if p <= NARROW_MAX_P:
        return 0
    if p <= WIDE_MAX_P:
        if kind != "stream":
            return 0
        if widths is None:
            return RW_WS_FLOATS
        return max((ratio_wide_slots(G, p, W) * ratio_wide_slot_floats(p, W)
                    for W in widths), default=0)
    if panel_phase(p, kind):
        floats = phase_ws_floats(p, min(G, sms), G)
        if kind == "loop":
            res = [W for W in widths or () if W <= MAX_W and p * W <= MAX_PW]
            floats += trim_phase_floats(
                p, max(res) if res else MAX_PW // p, TRIM_MAX_BINS, G)
        return floats
    return sms // pcl_size(p) * pcl_ws_floats(p)


def panel_workspace_bytes(p: int, device: torch.device,
                          kinds=WORKSPACE_KINDS, genes: int = 1 << 16,
                          widths=None) -> int:
    """Bytes of the largest workspace a launch at p of one of ``kinds``
    (``workspace_kinds``: those the fit launches) takes on ``device`` with
    buckets of at most ``genes`` genes of ``widths``: what the engine's
    memory guard sets aside on a card (0 at p <= NARROW_MAX_P and off a
    card, where the plain versions run), ``kind_workspace_floats``'
    largest."""
    if p <= NARROW_MAX_P or device.type != "cuda":
        return 0
    sms = panel_slots(1 << 30, device)
    return 4 * max((kind_workspace_floats(p, k, sms, genes, widths)
                    for k in kinds), default=0)


# The cluster layout of the panel instances (mirror of csrc/panel.cuh's
# pcl_* code): for WIDE_MAX_P < p <= ``pcl_max_p(kind)`` a gene's T =
# pmax_of(p) / PANEL_ROWS row panels give T(T+1)/2 panel pairs over a
# cluster (``pcl_size``: at most PCL_MAX_C blocks up to T = PCL_MAX_C, T
# blocks past it), ``pcl_held`` pairs a block, the diagonal pairs first.
# Where a block holds one pair (T = 2) B and B^2 live in the cluster's
# shared memory and the launch takes no workspace; where it holds several,
# in a workspace a cluster in flight (``pcl_ws_floats``).  Past T =
# PCL_MAX_C the blocks share the power step's matvecs
# (``pcl_shared_power``).  The cut is a rule by kind (``pcl_max_p``):
# kernels 1 ("nmf") and 3 ("loop") at PCL_MAX_P, kernels 2 and 4
# ("stream") at PCL_MAX_P_STREAM (a cluster of 9, not portable, past
# 1,024); above it every kernel takes the phased layout (``panel_phase``).
PCL_MAX_P = 640
PCL_MAX_P_STREAM = 1152
PCL_KINDS = ("loop", "stream")
PCL_NX = 2      # p-vectors of the kernel's own
# most blocks of a cluster up to T = PCL_MAX_C: an H100 holds 39 clusters of
# 3 at once but 7 of 10 or 15 (a cluster's blocks on one of its GPCs, an SM
# a block); the largest portable cluster
PCL_MAX_C = 5
PCL_PORTABLE = 8


def pcl_max_p(kind: str) -> int:
    """Most p of a kind's cluster layout (``dn_pcl_max_p``): "nmf" (kernel
    1) and "loop" (kernel 3) share DN_PCL_LOOP's, "stream" for kernels 2 and
    4."""
    return {"nmf": PCL_MAX_P, "loop": PCL_MAX_P,
            "stream": PCL_MAX_P_STREAM}[kind]


def panel_cluster(p: int, kind: str) -> bool:
    """True where the kernels of ``kind`` run p on the cluster layout
    (``dn_pcl_on``)."""
    return WIDE_MAX_P < p <= pcl_max_p(kind)


def pcl_T(p: int) -> int:
    """Row panels of a gene at p (``dn_pcl_T``)."""
    return pmax_of(p) // PANEL_ROWS


def pcl_pairs(p: int) -> int:
    """Panel pairs of a gene at p (``dn_pcl_pairs``)."""
    T = pcl_T(p)
    return T * (T + 1) // 2


def pcl_held(p: int) -> int:
    """Pairs a block of the cluster holds (``dn_pcl_held``): the pairs over
    PCL_MAX_C blocks, or past T = PCL_MAX_C over T."""
    return -(-pcl_pairs(p) // max(pcl_T(p), PCL_MAX_C))


def pcl_size(p: int) -> int:
    """Blocks of a gene's cluster at p (``dn_pcl_size``): the pairs,
    ``pcl_held`` a block."""
    return -(-pcl_pairs(p) // pcl_held(p))


def pcl_shared_power(p: int) -> bool:
    """True where the blocks of kernel 4's cluster share the power step's
    matvecs, a panel of rows each (``dn_pcl_shared_power``: past T =
    PCL_MAX_C); kernel 2's share them at every p."""
    return pcl_T(p) > PCL_MAX_C


def pcl_ws_floats(p: int) -> int:
    """Floats of a cluster's workspace (``dn_pcl_ws_floats``): B, B^2, B^T
    and B^2's transpose of every pair where a block holds several, else
    0."""
    if pcl_held(p) == 1:
        return 0
    return pcl_pairs(p) * (2 * PANEL_ROWS * (PANEL_ROWS + 4)
                           + 2 * PANEL_ROWS * PANEL_ROWS)


def pcl_pair(T: int, e: int) -> Tuple[int, int]:
    """Panels (I, J), I <= J, of pair e (block e of the cluster) of T
    panels (``dn_pcl_pair``): the diagonal pairs first, then the others in
    row order."""
    if e < T:
        return e, e
    e -= T
    i = 0
    while e >= T - 1 - i:
        e -= T - 1 - i
        i += 1
    return i, i + 1 + e


def pcl_smem_bytes(p: int) -> int:
    """Dynamic shared memory of a block of the cluster layout
    (``dn_pcl_smem_floats``): two tiles (after a sweep B and B^2), the
    copies of A0 (two slots of int16 or one of float32; B^2's staging in
    the power step), the v partials, the published partials, scratch,
    4 + PCL_NX p-vectors and the published rows of a shared matvec (two
    panels)."""
    pair = PANEL_ROWS * (PANEL_ROWS + 4)
    stage_a = 2 * PANEL_ROWS * 64
    return 4 * (2 * pair + stage_a + 6 * 64 + 32 + 4
                + (4 + PCL_NX) * pmax_of(p) + 2 * PANEL_ROWS)


def pcl_ldx(p: int) -> int:
    """Floats a column of a gene's X takes in the scratch of the cluster
    layout (``dn_pcl_ldx``: X stored column by column, p rounded up to a
    multiple of 4)."""
    return -(-p // 4) * 4


# The phased layout of kernels 2 and 4 past PCL_MAX_P_STREAM and of kernels
# 1 and 3 past PCL_MAX_P (mirror of csrc/phase.cuh's dn_phase_* code): a call
# lists its active genes on the card and runs them in groups of at most
# ``panel_slots`` genes, each gene of a group with its slot of the
# workspace (B and B^2, p x ``phase_ldb(p)`` floats each, u and PHASE_SCAL
# scalars: s, B's largest entry, the nmf_tol branch's frozen flag and
# iterations), through a fixed sequence of launches (csrc/stream_phase.cu,
# which kernel 1's csrc/nmf_panel.cu and kernel 3's csrc/trim_panel.cu
# call, and csrc/ratio_phase.cu).  The launches' geometry is modelled in
# tests/test_torch_panelphase.py.  Kernel 3 keeps its trim state after the
# layout's workspace (``trim_phase_floats``, csrc/trim_panel.cu's
# dn_trim_phase_floats): u, E and the round's scores, TRIM_ST ints a gene,
# the round's iterations, the round's count, and bytes: the round's list
# flag and TRIM_MAX_BINS bin flags at most.
PHASE_SCAL = 4
TRIM_ST = 6
TRIM_MAX_BINS = 64     # csrc/trim.cuh's DN_MAX_BINS


def panel_phase(p: int, kind: str = "stream") -> bool:
    """True where the kernels of ``kind`` run p on the phased layout
    (``dn_phase_on``, a rule by kernel): kernels 2 and 4 ("stream") past
    PCL_MAX_P_STREAM, kernels 1 ("nmf") and 3 ("loop") past PCL_MAX_P."""
    return p > pcl_max_p(kind)


def phase_ldb(p: int) -> int:
    """Floats a row of a gene's B and B^2 takes (``dn_phase_ldb``)."""
    return -(-p // 4) * 4


def phase_slot_floats(p: int) -> int:
    """Floats of a gene's slot (``dn_phase_slot_floats``): B, B^2, u and
    the scalars (s, B's largest entry)."""
    return 2 * p * phase_ldb(p) + pmax_of(p) + PHASE_SCAL


def phase_ws_floats(p: int, slots: int, G: int) -> int:
    """Floats of a call's workspace (``dn_phase_ws_floats``): ``slots``
    slots, kernel 4's scales and their reciprocals, and the list of active
    genes (its count, then up to G)."""
    return slots * phase_slot_floats(p) + 2 * pmax_of(p) + G + 1


def trim_phase_floats(p: int, W: int, B: int, G: int) -> int:
    """Floats of kernel 3's trim state past PCL_MAX_P
    (``dn_trim_phase_floats``), after ``phase_ws_floats``."""
    return G * p + 2 * G * W + G * (TRIM_ST + 1) + 1 + (G * (B + 1) + 3) // 4


def scratch_shape(G: int, p: int, W: int,
                  kind: str) -> Tuple[int, int, int]:
    """Shape of the X scratch of kernel 4 (``kind`` "stream") or of kernels
    1 and 3 ("loop") at (G, p, W): (G, W, pcl_ldx(p)) on the kind's cluster
    layout, else (G, p, W)."""
    return (G, W, pcl_ldx(p)) if panel_cluster(p, kind) else (G, p, W)


def loop_scratch_shape(G: int, p: int, W: int) -> Tuple[int, ...]:
    """Shape of kernels 1 and 3's X scratch: none where the resident core
    holds X in shared memory (``res_core``), else ``scratch_shape``."""
    return (0,) if res_core(p) else scratch_shape(G, p, W, "loop")


def kernel_workspace(G: int, p: int, device, kind: str, W: int = 0,
                     B: int = 0):
    """(workspace, slots) of a launch at p of kernel 1 (``kind`` "nmf"),
    kernel 3 ("loop", its bucket W columns wide with B bins) or kernels 2
    and 4 ("stream"): on the kind's cluster layout ``pcl_ws_floats`` a
    cluster the card can hold at once (one an SM a block; none where a
    block holds one pair); past it the phased layout, ``phase_ws_floats``
    at ``panel_slots`` genes a group (kernel 3: and ``trim_phase_floats``);
    none at p <= WIDE_MAX_P."""
    if panel_phase(p, kind) and G > 0:
        slots = panel_slots(G, device)
        floats = phase_ws_floats(p, slots, G)
        if kind == "loop":
            floats += trim_phase_floats(p, W, B, G)
        return (torch.empty(floats, dtype=torch.float32, device=device),
                slots)
    if not panel_cluster(p, kind) or pcl_held(p) == 1 or G == 0:
        return None, 0
    slots = min(G, panel_slots(1 << 30, device) // pcl_size(p))
    return (torch.empty(slots * pcl_ws_floats(p), dtype=torch.float32,
                        device=device), slots)


def warp_slots(p: int) -> int:
    """Warps the card holds at once in the loop kernels at p: 16 an SM at
    p <= 8 (their launch bound leaves 128 registers a thread), 8 above."""
    return SMS * max_loop_threads(p) // 32


def warp_gene_bytes(p: int, W: int) -> int:
    """Shared memory one warp of the warp-a-gene kernel 1 needs with X in
    device memory: its Gram, its Gram tile and u at p >= 16, and W uint16
    column indices (mirror of ``warp_gene_floats`` in csrc/nmf.cu)."""
    P = pmax_of(p)
    work = P * 33 + P if P >= 16 else 0
    return 4 * (P * (P + 1) // 2 + work + (W + 1) // 2)


# Warps a block of the warp-a-gene launch of kernel 1, and the largest p it
# takes (its PMAX = 32 instance spilled registers: csrc/nmf.cu).
GENE_WARPS = 4
GENE_WARP_MAX_P = 16


def pick_nmf_geometry(p: int, W: int, G: int) -> Tuple[str, int]:
    """Launch of kernel 1 for a (G, p, W) bucket: ("block", threads), one
    block a gene with ``pick_loop_threads`` threads, or ("warp", threads),
    one warp a gene and ``threads / 32`` genes a block at a time.

    A warp a gene pays a sweep's fixed cost (the Gram reduction and the
    power step) once instead of once a warp, but gives a gene 32 threads:
    it wins where the bucket has enough genes to fill the card's warps
    (``warp_slots``); a bucket of fewer, wider genes keeps a block a gene
    (the measurements: PERF.md, ``chip_smoke.py --sweep``).  p above
    ``GENE_WARP_MAX_P`` always takes a block a gene."""
    if p <= GENE_WARP_MAX_P and G >= warp_slots(p):
        return "warp", 32 * GENE_WARPS
    return "block", pick_loop_threads(p, W)


# KB of shared memory a block of kernel 2 copies its share of a gene into:
# more lets fewer blocks in flight (the committed sweep: 24 is within 2% of
# the best at every bucket and the best at the two wide ones).
RATIO_COPY_KB = 24


def pick_ratio_geometry(p: int, W: int, G: int) -> Tuple[int, int, int]:
    """(blocks a gene, threads a block, KB a block copies) of a launch of
    kernel 2 for a (G, p, W) bucket, the rule of the committed sweep
    (``chip_smoke.py --sweep``, PERF.md): the smallest cluster that leaves a
    block at most 64 KB of a gene's int16 coverage (8 past that); 128
    threads a block where the launch has 8,192 blocks or more (each block
    waits on a cold power step of serial matvecs, so there the number of
    blocks in flight decides), else 256 (few genes: more loads in flight
    each).  No dtype enters, so int16 and float32 input share a launch and
    give the same bits.  p > NARROW_MAX_P: the wide and panel instances,
    blocks of WIDE_THREADS and no copy (the wide instance's chunks:
    ``ratio_wide_chunks``)."""
    if p > NARROW_MAX_P:
        return 1, WIDE_THREADS, 0
    for cl in (1, 2, 4, 8):
        if p * -(-W // cl) * 2 <= 65536:
            break
    return cl, (128 if G * cl >= 8192 else 256), RATIO_COPY_KB


# Kernel 2's wide instance (csrc/ratio_wide.cuh, mirror of its dn_rw_*
# code the wrapper needs): a gene's columns in chunks of RW_CHUNK_TILES
# tiles of WIDE_TC columns, each chunk's partial Gram and row sums in the
# gene's slot of the workspace (with u and RW_SCAL scalars), the genes in
# groups of ``ratio_wide_slots``, the workspace at most RW_WS_FLOATS floats
# where a slot fits.  The launches' geometry is modelled in
# tests/test_torch_ratiowide.py.
WIDE_TC = 64
RW_CHUNK_TILES = 16
RW_SCAL = 4
RW_WS_FLOATS = 1 << 25


def ratio_wide_chunks(W: int) -> int:
    """Chunks of a gene of W columns (``dn_rw_chunks``)."""
    tiles = -(-W // WIDE_TC)
    return -(-tiles // RW_CHUNK_TILES) if tiles > RW_CHUNK_TILES else 1


def ratio_wide_slot_floats(p: int, W: int) -> int:
    """Floats of a gene's slot (``dn_rw_slot_floats`` at p's PMAX)."""
    pm = pmax_of(p)
    return ratio_wide_chunks(W) * (pm * pm + pm) + pm + RW_SCAL


def ratio_wide_slots(G: int, p: int, W: int) -> int:
    """Genes of a group of kernel 2's wide instance: as many slots as
    RW_WS_FLOATS holds (at least one), at most G."""
    return min(G, max(1, RW_WS_FLOATS // ratio_wide_slot_floats(p, W)))


def ratio_wide_workspace(G: int, p: int, W: int, device):
    """(workspace, slots) of a launch of kernel 2's wide instance."""
    slots = ratio_wide_slots(G, p, W)
    return (torch.empty(slots * ratio_wide_slot_floats(p, W),
                        dtype=torch.float32, device=device), slots)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _as_u8(mask: torch.Tensor) -> torch.Tensor:
    m = mask if mask.dtype == torch.bool else (mask != 0)
    return m.contiguous().view(torch.uint8)


# --------------------------------------------------------------------------
# kernel 1: Lagrangian NMF-OA loop
# --------------------------------------------------------------------------

def nmf_masked_plain(
    F: torch.Tensor,
    mask: torch.Tensor,
    *,
    nmf_iter: int,
    power_iters_cold: int = 30,
    power_iters_warm: int = 6,
    power_warm_plain: int = 0,
    gene_active: Optional[torch.Tensor] = None,
    u0: Optional[torch.Tensor] = None,
    nmf_tol: float = 0.0,
    method: str = "power",
    iters_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the NMF-OA loop (X-form update, scale-free (u, v)
    carry): A0 = F·mask, cold rank-1, then ``nmf_iter`` times
    X <- max(X - (u⊗v - A0)/sqrt(nmf_iter), A0) with a warm refit of u and
    v = Xᵀu; finally K = u·s, E = v/s.

    ``power_warm_plain`` = 0 runs the squared warm scheme at
    ``power_iters_warm`` (the JAX package's XLA twin); > 0 runs that many
    plain matvecs (its fused kernels).  ``gene_active``: genes outside it
    return zeros, as the kernel does.  ``nmf_tol`` > 0: the adaptive loop
    (``nmf_loop_plain``).  ``method="eigh"``: every fit by a batched
    eigendecomposition (no kernel has it).  ``iters_out``: an int32 (G,)
    tensor that receives the Lagrangian iterations each gene ran (0 for an
    inactive gene), as the kernel reports them.  Returns (K, E, u).
    """
    return nmf_loop_plain(F * mask.to(F.dtype)[:, None, :], mask,
                          nmf_iter=nmf_iter, power_iters_cold=power_iters_cold,
                          power_iters_warm=power_iters_warm,
                          power_warm_plain=power_warm_plain,
                          gene_active=gene_active, u0=u0, nmf_tol=nmf_tol,
                          method=method, iters_out=iters_out)


def nmf_loop_plain(A0, mask, *, nmf_iter, power_iters_cold, power_iters_warm,
                   power_warm_plain, gene_active, u0, nmf_tol=0.0,
                   method="power", iters_out=None, X=None):
    """The loop of ``nmf_masked_plain`` from the masked coverage A0 on; the
    streamed kernel's plain version (ops/cuda_stream.py) shares it.  ``X``:
    multipliers (X = A0 + lambda, zero off the mask) to start from instead
    of A0, refit cold from and updated in place (trim_fast's rounds)."""
    step = 1.0 / (nmf_iter ** 0.5) if nmf_iter else 0.0
    G = A0.shape[0]
    if nmf_tol > 0:
        K, E, u, iters = _adaptive_loop(
            A0, mask, step, nmf_iter=nmf_iter,
            power_iters_cold=power_iters_cold,
            power_iters_warm=power_iters_warm,
            power_warm_plain=power_warm_plain, gene_active=gene_active,
            u0=u0, nmf_tol=nmf_tol, method=method)
    else:
        u, v = masked_rank_one_uv(A0 if X is None else X, mask,
                                  n_iters=power_iters_cold, u0=u0,
                                  method=method)
        # X is updated in place: the loop holds one (G, p, W) state, not one
        # per iteration.
        X = A0.clone() if X is None else X
        for _ in range(nmf_iter):
            est = outer_product(u, v)
            est.sub_(A0).mul_(step)
            torch.maximum(X.sub_(est), A0, out=X)
            u, v = masked_rank_one_uv(X, mask, n_iters=power_iters_warm, u0=u,
                                      warm_plain=power_warm_plain,
                                      method=method)
        K, E = finish_rank_one(X, mask, u, v)
        iters = torch.full((G,), nmf_iter, dtype=torch.int32, device=A0.device)
    if gene_active is not None:
        act = gene_active.to(A0.dtype)[:, None]
        K, E, u = K * act, E * act, u * act
        iters = iters * gene_active.to(torch.int32)
    if iters_out is not None:
        iters_out.copy_(iters)
    return K, E, u


def _adaptive_loop(A0, mask, step, *, nmf_iter, power_iters_cold,
                   power_iters_warm, power_warm_plain, gene_active, u0,
                   nmf_tol, method):
    """The ``nmf_tol > 0`` loop (``degnorm_tpu/ops/pallas_nmf.py::_nmf_loop``
    and its XLA twin, ``core/nmf.py``): the (K, E, u) carry with est = K⊗E,
    and a gene freezes its (X, K, E, u) after the first iteration whose
    max|ΔK| <= nmf_tol · max(max|K|, 1e-30), the update of that iteration
    kept.  Each gene's result depends on its own history alone, so the batch
    may stop once its active genes have frozen.  Returns (K, E, u, iters)."""
    G = A0.shape[0]
    dev = A0.device
    K, E, u = masked_rank_one(A0, mask, n_iters=power_iters_cold, u0=u0,
                              method=method)
    X = A0.clone()
    done = torch.zeros(G, dtype=torch.bool, device=dev)
    live = (torch.ones_like(done) if gene_active is None
            else gene_active.to(torch.bool))
    iters = torch.zeros(G, dtype=torch.int32, device=dev)
    for _ in range(nmf_iter):
        if not bool((live & ~done).any()):
            break
        # the candidate update of every gene, discarded for the frozen
        Xn = outer_product(K, E)
        Xn.sub_(A0).mul_(step)
        torch.sub(X, Xn, out=Xn)
        torch.maximum(Xn, A0, out=Xn)
        Kn, En, un = masked_rank_one(Xn, mask, n_iters=power_iters_warm,
                                     u0=u, warm_plain=power_warm_plain,
                                     method=method)
        keep = done[:, None]
        Xn[done] = X[done]
        X = Xn
        Kn = torch.where(keep, K, Kn)
        En = torch.where(keep, E, En)
        un = torch.where(keep, u, un)
        delta = (Kn - K).abs().amax(dim=1)
        ref = torch.clamp_min(Kn.abs().amax(dim=1), 1e-30)
        iters += (~done).to(torch.int32)
        done = done | (delta <= nmf_tol * ref)
        K, E, u = Kn, En, un
    return K, E, u, iters


def nmf_masked_cuda(
    F: torch.Tensor,
    mask: torch.Tensor,
    *,
    nmf_iter: int,
    power_iters_cold: int = 30,
    power_iters_warm: int = 6,
    power_warm_plain: int = 0,
    gene_active: Optional[torch.Tensor] = None,
    u0: Optional[torch.Tensor] = None,
    nmf_tol: float = 0.0,
    iters_out: Optional[torch.Tensor] = None,
    bucket_genes: Optional[int] = None,
    _geometry: Optional[Tuple[str, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel wrapper with ``nmf_masked_plain``'s signature: one thread
    block, or one warp, per gene runs the whole loop (csrc/nmf.cu), as
    ``pick_nmf_geometry`` chooses; ``nmf_tol > 0`` launches the kernel's
    adaptive instance (csrc/nmf_tol.cu), where a gene leaves its own loop
    once frozen.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises.  Results differ between the two launches
    by float32 summation order alone.  ``iters_out``: see
    ``nmf_masked_plain``.  ``bucket_genes``: the gene count the launch rule
    reads in place of F's, where F is one shard of a bucket of that many
    genes (parallel/): every shard then launches as the whole bucket would,
    and gives its bits.

    ``_geometry`` overrides the rule's launch (the timing sweep of
    ``chip_smoke.py --sweep`` and the check of both launches in
    ``chip_smoke.py`` pass it; nothing else does)."""
    kwargs = dict(nmf_iter=nmf_iter, power_iters_cold=power_iters_cold,
                  power_iters_warm=power_iters_warm,
                  power_warm_plain=power_warm_plain,
                  gene_active=gene_active, u0=u0, nmf_tol=nmf_tol,
                  iters_out=iters_out)
    if F.device.type == "cpu":
        return nmf_masked_plain(F, mask, **kwargs)
    global nmf_launches, nmf_tol_launches, nmf_wide_launches
    global nmf_wide_tol_launches, nmf_panel_launches, nmf_panel_tol_launches
    global nmf_panel_phase_launches
    from degnorm_tpu_torch.ops.build import check_launch, get_lib
    check_kernel_input(F, "nmf_masked_cuda")
    G, p, W = F.shape
    kind, threads = _geometry or pick_nmf_geometry(p, W, bucket_genes or G)
    m8 = _as_u8(mask)
    act8 = None if gene_active is None else _as_u8(gene_active)
    u0c = None if u0 is None else u0.to(torch.float32).contiguous()
    dev = F.device
    if iters_out is not None and (iters_out.dtype != torch.int32
                                  or iters_out.shape != (G,)
                                  or iters_out.device != dev):
        raise ValueError("nmf_masked_cuda: iters_out must be an int32 (G,) "
                         "tensor on the coverage's device")
    # Scratch and converted inputs may be dropped as soon as this returns:
    # the caching allocator reuses a block only for work queued later on
    # this same stream, after the kernel.
    X = torch.empty(loop_scratch_shape(G, p, W), dtype=torch.float32,
                    device=dev)  # scratch
    K = torch.empty((G, p), dtype=torch.float32, device=dev)
    E = torch.empty((G, W), dtype=torch.float32, device=dev)
    u = torch.empty((G, p), dtype=torch.float32, device=dev)
    if G == 0:
        return K, E, u
    ws, slots = kernel_workspace(G, p, dev, "nmf")
    loop = (int(nmf_iter), int(power_iters_cold), int(power_iters_warm),
            int(power_warm_plain), float(nmf_tol), _ptr(iters_out), threads)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "block":
            name = "dn_nmf_masked"
            code = get_lib().dn_nmf_masked(
                F.data_ptr(), m8.data_ptr(), _ptr(act8), _ptr(u0c),
                X.data_ptr(), K.data_ptr(), E.data_ptr(), u.data_ptr(),
                G, p, W, *loop, _ptr(ws), slots, stream)
        else:
            name = "dn_nmf_masked_warp"
            nxt = torch.zeros(1, dtype=torch.int32, device=dev)
            code = get_lib().dn_nmf_masked_warp(
                F.data_ptr(), m8.data_ptr(), _ptr(act8), _ptr(u0c),
                nxt.data_ptr(), X.data_ptr(), K.data_ptr(), E.data_ptr(),
                u.data_ptr(), G, p, W, *loop, stream)
    check_launch(code, name)
    nmf_launches += 1
    if nmf_tol > 0:
        nmf_tol_launches += 1
    if p > WIDE_MAX_P:
        nmf_panel_launches += 1
        nmf_panel_tol_launches += nmf_tol > 0
        nmf_panel_phase_launches += panel_phase(p, "nmf")
    elif p > NARROW_MAX_P:
        nmf_wide_launches += 1
        nmf_wide_tol_launches += nmf_tol > 0
    return K, E, u


# --------------------------------------------------------------------------
# kernel 2: ratio-SVD row sums
# --------------------------------------------------------------------------

def ratio_rowsums_plain(
    F: torch.Tensor,
    mask: torch.Tensor,
    *,
    power_iters: int = 30,
    method: str = "power",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: one cold rank-1 of A0 = F·mask, est = max(K⊗E, A0),
    and the row sums over active columns of F and of est (reference
    ``ratio_svd``, nmf.py:109-121,522-526).  Integer coverage (the engine's
    int16 upload) is cast to float32 first, which is exact.
    ``method="eigh"``: the rank-1 by a batched eigendecomposition (no kernel
    has it).  Returns (cov_sums, est_sums)."""
    if not F.dtype.is_floating_point:
        F = F.to(torch.float32)
    m = mask.to(F.dtype)
    K, E, _ = masked_rank_one(F, mask, n_iters=power_iters, method=method)
    est = torch.maximum(outer_product(K, E), F * m[:, None, :])
    est_sums = torch.einsum("gpw,gw->gp", est, m)
    cov_sums = torch.einsum("gpw,gw->gp", F, m)
    return cov_sums, est_sums


def ratio_rowsums_cuda(
    F: torch.Tensor,
    mask: torch.Tensor,
    *,
    power_iters: int = 30,
    bucket_genes: Optional[int] = None,
    _geometry: Optional[Tuple[int, int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper with ``ratio_rowsums_plain``'s signature
    (csrc/ratio.cuh; 33 <= p <= 128 csrc/ratio_wide.cuh's phases over the
    card, with ``ratio_wide_workspace``; p > 128 csrc/ratio_panel.cu, on
    kernel 4's layout, past PCL_MAX_P_STREAM csrc/ratio_phase.cu's phased
    layout), at
    any width, on float32 coverage or the raw int16 upload as it is (the
    same bits as its float32 cast).  The kernel reads a
    gene once and writes 2p floats, so a wide bucket costs it time and no
    memory.  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises.  ``bucket_genes``: as in ``nmf_masked_cuda``.
    ``_geometry`` overrides ``pick_ratio_geometry`` (the timing sweep of
    ``chip_smoke.py --sweep`` passes it)."""
    if F.device.type == "cpu":
        return ratio_rowsums_plain(F, mask, power_iters=power_iters)
    global ratio_launches, ratio_wide_launches, ratio_panel_launches
    global ratio_panel_cluster_launches, ratio_panel_phase_launches
    from degnorm_tpu_torch.ops.build import check_launch, get_lib
    check_coverage_input(F, "ratio_rowsums_cuda", int16_ok=True)
    G, p, W = F.shape
    cl, threads, stage_kb = _geometry or pick_ratio_geometry(
        p, W, bucket_genes or G)
    m8 = _as_u8(mask)
    cov = torch.empty((G, p), dtype=torch.float32, device=F.device)
    est = torch.empty((G, p), dtype=torch.float32, device=F.device)
    if G == 0:
        return cov, est
    ws, slots = (ratio_wide_workspace(G, p, W, F.device)
                 if NARROW_MAX_P < p <= WIDE_MAX_P
                 else kernel_workspace(G, p, F.device, "stream"))
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = get_lib().dn_ratio_rowsums(
            F.data_ptr(), int(F.dtype == torch.int16), m8.data_ptr(),
            cov.data_ptr(), est.data_ptr(), G, p, W, int(power_iters), cl,
            threads, stage_kb, _ptr(ws), slots, stream)
    check_launch(code, "dn_ratio_rowsums")
    ratio_launches += 1
    if p > WIDE_MAX_P:
        ratio_panel_launches += 1
        ratio_panel_cluster_launches += panel_cluster(p, "stream")
        ratio_panel_phase_launches += panel_phase(p)
    elif p > NARROW_MAX_P:
        ratio_wide_launches += 1
    return cov, est


# --------------------------------------------------------------------------
# kernel 2c: ratio-SVD row sums of a column-sharded bucket
# --------------------------------------------------------------------------

def ratio_rowsums_colsharded_plain(
    F: torch.Tensor,
    mask: torch.Tensor,
    cols,
    *,
    power_iters: int = 30,
    method: str = "power",
):
    """Plain version of kernel 2c, a step generator: ``ratio_rowsums_plain``
    on one shard's columns of every gene (``cols``:
    ``parallel/seqpar.py::Columns``), with the p x p Gram summed across the
    shards before the power step and the (G, 2p) row sums of A0 and of
    max(K⊗E, A0) after it.  Returns (cov_sums, est_sums), whole on every
    shard."""
    from degnorm_tpu_torch.core.linalg import (_EPS, _dominant, _gram,
                                               _scale_of)
    if not F.dtype.is_floating_point:
        F = F.to(torch.float32)
    m = mask.to(F.dtype)
    A = F * m[:, None, :]
    B = yield from cols.sum_(_gram(A))
    u = _dominant(B, None, A, power_iters, 0, method)
    s = _scale_of(B, u)
    K = u * s[:, None]
    E = torch.einsum("gpw,gp->gw", A, u) / (s[:, None] + _EPS)
    est = torch.maximum(outer_product(K, E), A)
    sums = yield from cols.sum_(torch.cat(
        [torch.einsum("gpw,gw->gp", F, m), torch.einsum("gpw,gw->gp", est, m)],
        dim=1))
    p = F.shape[1]
    return sums[:, :p], sums[:, p:]


def ratio_rowsums_colsharded_cuda(
    F: torch.Tensor,
    mask: torch.Tensor,
    cols,
    *,
    power_iters: int = 30,
    method: str = "power",
):
    """Kernel wrapper with ``ratio_rowsums_colsharded_plain``'s signature, a
    step generator (csrc/ratio_cols.cu): one launch writes each gene's
    partial Gram of A0 over the shard's columns into this shard's slot of
    the group's buffer (kernel 4c's launch (a), with no X); a second sums
    every shard's partial (``cols.gather_``: unsummed, in shard order), runs
    the cold power step on the sum and writes the partial row sums of A0
    and of max(K⊗E, A0), which are summed across the shards (``cols.sum_``);
    past NARROW_MAX_P the power step is a kernel of its own, once a gene,
    its u, K and s in a workspace of G (2p + 1) floats
    (``cuda_stream.ratio_cols_calls``).
    Takes float32 coverage or the raw int16 upload as it is, 2 <= p <=
    COLS_MAX_P (above NARROW_MAX_P the wide instance); a gene's
    columns are spread over the blocks of
    ``cuda_stream.pick_cols_geometry`` for the bucket's genes
    (``cols.genes``).  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises (``method="eigh"`` has no kernel)."""
    if F.device.type == "cpu":
        return (yield from ratio_rowsums_colsharded_plain(
            F, mask, cols, power_iters=power_iters, method=method))
    global ratio_cols_launches, ratio_cols_wide_launches
    from degnorm_tpu_torch.ops import cuda_stream
    from degnorm_tpu_torch.ops.build import check_launch, get_lib
    name = "ratio_rowsums_colsharded_cuda"
    if method != "power":
        raise NotImplementedError(f"{name}: method={method!r} has no kernel")
    check_coverage_input(F, name, int16_ok=True, max_p=COLS_MAX_P)
    G, p, W = F.shape
    nb, threads = cuda_stream.pick_cols_geometry(cols.genes, p, W)
    dev = F.device
    m8 = _as_u8(mask)
    i16 = int(F.dtype == torch.int16)
    sums = torch.empty((G, 2 * p), dtype=torch.float32, device=dev)
    if G == 0:
        return sums[:, :p], sums[:, p:]
    ng = cuda_stream.packed_gram_floats(p)
    slots = cols.partials((G, ng), dev)
    counts = torch.zeros((2, G), dtype=torch.int32, device=dev)
    ncols, tickets = counts[0], counts[1]
    bpart = (torch.empty((G, nb, max(ng, 2 * p)), dtype=torch.float32,
                         device=dev) if nb > 1 else None)
    wide = p > NARROW_MAX_P
    ws = (torch.empty(G * (2 * p + 1), dtype=torch.float32, device=dev)
          if wide else None)
    lib = get_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        check_launch(lib.dn_cols_gram(
            F.data_ptr(), i16, m8.data_ptr(), None, None, None,
            slots[0, cols.shard].data_ptr(), _ptr(bpart), tickets.data_ptr(),
            ncols.data_ptr(), G, p, W, nb, threads, stream), "dn_cols_gram")
        ratio_cols_launches += 1
        ratio_cols_wide_launches += p > NARROW_MAX_P
    parts = yield from cols.gather_(slots[0])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        check_launch(lib.dn_ratio_cols_sums(
            F.data_ptr(), i16, m8.data_ptr(), parts.data_ptr(), cols.count,
            ncols.data_ptr(), sums.data_ptr(), _ptr(bpart),
            tickets.data_ptr(), _ptr(ws), G, p, W, int(power_iters), nb,
            threads, stream), "dn_ratio_cols_sums")
        per = cuda_stream.cols_step_kernels(p)
        ratio_cols_launches += per
        ratio_cols_wide_launches += per * wide
    sums = yield from cols.sum_(sums)
    return sums[:, :p], sums[:, p:]
