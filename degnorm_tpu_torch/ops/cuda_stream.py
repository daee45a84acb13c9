"""The NMF-OA loop for wide buckets: CUDA kernel wrapper and its plain
PyTorch version.

Counterpart of ``degnorm_tpu/ops/pallas_stream.py`` (``nmf_masked_streamed``).
Same function as ``ops/cuda_nmf.py::nmf_masked_*`` for buckets outside the
resident kernels' gate (few genes, each p x W of half a megabyte and more),
with one more input form: with ``scale`` the coverage is the engine's RAW
device-resident int16 tensor and the kernel casts, divides and masks each
column itself, in the order of ``engine._bucket_step``, so the result equals
that of the pre-adjusted float32 form bit for bit (the plain version also
takes raw floating-point coverage with ``scale``).

The kernel (``csrc/stream.cuh``) spreads one gene over a cluster of thread
blocks whose size and threads the wrapper chooses by shape
(``pick_geometry``); the wrapper takes the plain version only for a tensor that lies on
the CPU, and for a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from degnorm_tpu_torch.core.linalg import outer_product
from degnorm_tpu_torch.ops import cuda_nmf

# Launch counters (plain ints): one is added where a kernel is launched;
# ``colsharded_launches`` counts every launch of kernel 4c (a, b and finish),
# ``colsharded_tol_launches`` those of its nmf_tol instances (in both).
stream_launches = 0
# the launches of its wide instances (cuda_nmf.NARROW_MAX_P < p <=
# cuda_nmf.WIDE_MAX_P: csrc/stream_wide.cuh) and of its panel instance (p >
# cuda_nmf.WIDE_MAX_P: csrc/stream_panel.cu), in stream_launches too
stream_wide_launches = 0
stream_panel_launches = 0
# ... of them, on the cluster layout (``cuda_nmf.panel_cluster(p, "stream")``)
# and on the phased layout past it (``cuda_nmf.panel_phase(p)``)
stream_panel_cluster_launches = 0
stream_panel_phase_launches = 0
colsharded_launches = 0
colsharded_tol_launches = 0
# ... of them, those of its wide instances (cuda_nmf.NARROW_MAX_P < p <=
# cuda_nmf.COLS_MAX_P: csrc/stream_cols_wide.cuh)
colsharded_wide_launches = 0

# Launch geometry of csrc/stream.cuh.  A gene is a cluster of 1, 2, 4 or 8
# thread blocks (8 is the largest portable cluster); its columns are dealt to
# the blocks in chunks of CHUNK, round robin.
CLUSTERS = (1, 2, 4, 8)
CHUNK = 128
# The most column slots the geometry rule gives a thread, while a cluster of
# 8 can keep to it (the kernel keeps a 64-bit mask of a thread's active slots
# in a register and rereads the mask past 64: csrc/common.cuh).
RULE_SLOTS = 32
# The most columns of a gene a block of a wide instance (p > 32) is dealt
# while a cluster of 8 can keep to it.
WIDE_BLOCK_COLS = 4096


def block_share(W: int, cl: int) -> int:
    """The most columns one of ``cl`` blocks is dealt of a gene of width W
    (whole chunks)."""
    chunks = -(-W // CHUNK)
    return -(-chunks // cl) * CHUNK


def block_columns(ncols: int, W: int, cl: int, rank: int):
    """The columns block ``rank`` of a gene's ``cl`` blocks sweeps when the
    gene's last active column is ``ncols - 1``: the mirror of
    ``StreamSrc::col`` in csrc/stream.cuh (chunks rank, rank + cl, ... below
    the gene's last chunk, cut at W)."""
    nch = -(-ncols // CHUNK)
    out = []
    for c in range(rank, nch, cl):
        out.extend(range(c * CHUNK, min((c + 1) * CHUNK, W)))
    return out


def pick_geometry(W: int, p: int) -> Tuple[int, int]:
    """(blocks a gene, threads a block) of a launch, by shape; the rule of
    the committed sweep (``chip_smoke.py --sweep``, PERF.md).

    A block has the most threads its instance takes (fewer only for a share
    of under a column a thread).  A gene gets the smallest cluster that
    leaves a thread at most ``256 / p`` column slots, and never more than
    ``RULE_SLOTS``: a cluster pays a barrier and p(p+1)/2 remote reads a
    block every sweep, so it is worth its cost only where a thread would
    have more columns than that, each of them about p * p operations.  The
    count of active genes does not enter: a larger cluster for a late trim
    round of few genes gained under 0.1 ms a launch.

    p > ``cuda_nmf.NARROW_MAX_P`` (the wide instances, csrc/stream_wide.cuh):
    WIDE_THREADS threads, and the smallest cluster that leaves a block at
    most WIDE_BLOCK_COLS of a gene's columns (a wide cluster pays two
    cluster barriers and p^2 remote reads a block every sweep, so it is
    kept for the widest buckets).  p > ``cuda_nmf.WIDE_MAX_P`` (the panel
    instance, csrc/stream_panel.cu): one block of WIDE_THREADS a gene."""
    if p > cuda_nmf.WIDE_MAX_P:
        return 1, cuda_nmf.WIDE_THREADS
    if p > cuda_nmf.NARROW_MAX_P:
        cl = next((c for c in CLUSTERS if block_share(W, c) <= WIDE_BLOCK_COLS),
                  CLUSTERS[-1])
        return cl, cuda_nmf.WIDE_THREADS
    max_threads = cuda_nmf.max_loop_threads(p)
    max_slots = min(RULE_SLOTS, max(1, 256 // p))

    def slots(cl):
        return -(-block_share(W, cl) // max_threads)

    cl = next((c for c in CLUSTERS if slots(c) <= max_slots), CLUSTERS[-1])
    threads = min(max_threads, max(32, (block_share(W, cl) + 31) // 32 * 32))
    return cl, threads


# Columns a thread of kernels 4c and 2c is dealt where a gene is spread over
# several blocks (the committed sweep: ``chip_smoke.py --sweep``, PERF.md).
COLS_A_THREAD = 4
# The most columns a block of their wide instances is dealt: its Gram sums
# each entry over the block's columns in one chain, and a chain over a whole
# shard of the long tail's bucket (32,768 columns) left the row sums of
# kernel 2c 1.1e-5 from the plain version; chains of at most this many keep
# it within the 1e-5 the narrow instances hold.
COLS_WIDE_BLOCK_COLS = 1024

# Threads of a sweep block of kernels 4c and 2c's wide instances
# (csrc/stream_cols_wide.cuh's DN_WCR_THREADS): eight consumer warps and a
# producer warp, which streams the block's tiles through a ring of stages
# (its layout and the static_assert that it fits are in the header).
COLS_WIDE_THREADS = 288


def cols_step_kernels(p: int) -> int:
    """Kernels a launch of kernel 4c's sweep or finish, or of kernel 2c's
    row sums, runs: past NARROW_MAX_P two (the power step once a gene, then
    the blocks), else one."""
    return 2 if p > cuda_nmf.NARROW_MAX_P else 1


def cols_calls(p: int, nmf_iter: int) -> Tuple[int, int]:
    """(kernel launches, gather asks) of a call of kernel 4c on a shard:
    (a), a sweep an iteration and the finish (``cols_step_kernels`` each)."""
    return 1 + cols_step_kernels(p) * (nmf_iter + 1), nmf_iter + 1


def ratio_cols_calls(p: int) -> Tuple[int, int]:
    """(kernel launches, gather asks) of a call of kernel 2c on a shard
    (one sum of the row sums besides): the Gram, then the row sums
    (``cols_step_kernels``)."""
    return 1 + cols_step_kernels(p), 1


def pick_cols_geometry(G: int, p: int, W: int,
                       n_sm: int = cuda_nmf.SMS) -> Tuple[int, int]:
    """(blocks a gene, threads a block) of kernels 4c and 2c on a shard of
    ``W`` columns of a bucket of ``G`` genes (csrc/stream_cols.cuh), by
    shape.  A launch must fill the card by itself (the shards of one card
    launch one after another): a gene gets ``ceil(n_sm / G)`` blocks, at
    most one a chunk of CHUNK columns, so one where the bucket's genes fill
    the SMs (the long tail's 384 slots) and a block an SM for one gene.  A
    block's share of a gene is dealt in chunks round robin
    (``block_columns``); it gets a thread for ``COLS_A_THREAD`` of its
    columns, in whole warps within the instance's bound; p >
    ``cuda_nmf.NARROW_MAX_P`` (the wide instances,
    csrc/stream_cols_wide.cuh) COLS_WIDE_THREADS, whatever its share, and
    enough blocks that none is dealt more than COLS_WIDE_BLOCK_COLS."""
    chunks = max(1, -(-W // CHUNK))
    nb = max(1, min(-(-n_sm // max(G, 1)), chunks))
    if p > cuda_nmf.NARROW_MAX_P:
        nb = max(nb, -(-chunks // (COLS_WIDE_BLOCK_COLS // CHUNK)))
        return nb, COLS_WIDE_THREADS
    share = block_share(W, nb)
    threads = min(cuda_nmf.max_loop_threads(p),
                  max(32, (-(-share // COLS_A_THREAD) + 31) // 32 * 32))
    return nb, threads


def packed_gram_floats(p: int) -> int:
    """Floats of a gene's packed partial Gram in kernels 4c and 2c: the
    upper triangle at the instance's PMAX."""
    P = cuda_nmf.pmax_of(p)
    return P * (P + 1) // 2


def _a0(F, mask, scale):
    """A0 of the streamed versions' input forms: with ``scale`` (p,), ``F``
    is the raw coverage (int16 or floating) and A0 = F.to(scale.dtype) /
    scale * mask, in exactly that order; otherwise A0 = F * mask (integer
    coverage cast to float32 first)."""
    if scale is not None:
        F = F.to(scale.dtype) / scale[None, :, None]
    elif not F.dtype.is_floating_point:
        F = F.to(torch.float32)
    return F * mask.to(F.dtype)[:, None, :]


def nmf_masked_streamed_plain(
    F: torch.Tensor,
    mask: torch.Tensor,
    *,
    nmf_iter: int,
    power_iters_cold: int = 30,
    power_iters_warm: int = 6,
    power_warm_plain: int = 0,
    gene_active: Optional[torch.Tensor] = None,
    u0: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version (A0: ``_a0``), then the loop of
    ``cuda_nmf.nmf_masked_plain``.  Returns (K, E, u); genes outside
    ``gene_active`` return zeros."""
    return cuda_nmf.nmf_loop_plain(
        _a0(F, mask, scale), mask, nmf_iter=nmf_iter,
        power_iters_cold=power_iters_cold, power_iters_warm=power_iters_warm,
        power_warm_plain=power_warm_plain, gene_active=gene_active, u0=u0)


def nmf_masked_streamed_cuda(
    F: torch.Tensor,
    mask: torch.Tensor,
    *,
    nmf_iter: int,
    power_iters_cold: int = 30,
    power_iters_warm: int = 6,
    power_warm_plain: int = 0,
    gene_active: Optional[torch.Tensor] = None,
    u0: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
    _geometry: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel wrapper with ``nmf_masked_streamed_plain``'s signature: one
    cluster of thread blocks per gene runs the whole loop (csrc/stream.cuh).
    Takes float32 coverage, or int16 coverage with or without ``scale``, of
    any width and any p >= 2 (p > 32 the wide instances of
    csrc/stream_wide.cuh, p > 128 the panel instance of
    csrc/stream_panel.cu: up to ``cuda_nmf.PCL_MAX_P_STREAM`` a cluster of
    blocks a gene, above the phased layout of csrc/stream_phase.cu, a gene's
    panel pairs over the whole card).  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises.

    The launch geometry comes from ``pick_geometry``; results differ between
    geometries by float32 summation order alone and are the same bits for
    the same geometry.  ``_geometry`` overrides (blocks a gene, threads): the
    timing sweep and the geometry check of ``chip_smoke.py`` pass it, nothing
    else does."""
    if F.device.type == "cpu":
        return nmf_masked_streamed_plain(
            F, mask, nmf_iter=nmf_iter, power_iters_cold=power_iters_cold,
            power_iters_warm=power_iters_warm,
            power_warm_plain=power_warm_plain, gene_active=gene_active,
            u0=u0, scale=scale)
    global stream_launches, stream_wide_launches, stream_panel_launches
    global stream_panel_cluster_launches, stream_panel_phase_launches
    from degnorm_tpu_torch.ops.build import check_launch, get_lib
    name = "nmf_masked_streamed_cuda"
    cuda_nmf.check_coverage_input(F, name, int16_ok=True)
    G, p, W = F.shape
    if scale is not None and tuple(scale.shape) != (p,):
        raise ValueError(f"{name}: scale must have shape ({p},), "
                         f"got {tuple(scale.shape)}")
    f32 = torch.float32
    dev = F.device
    # two forms reach the kernel: raw int16 with its scales, or finished
    # float32 coverage.  int16 without scales is divided by ones (exact); raw
    # float32 with scales saves no bytes over the finished form, so no caller
    # sends it and no instance takes it.
    if F.dtype == f32 and scale is not None:
        raise NotImplementedError(
            f"{name}: float32 coverage with scale is not taken on a CUDA "
            "tensor; divide it first (F / scale[None, :, None]) and pass no "
            "scale")
    if F.dtype == torch.int16 and scale is None:
        scale = torch.ones(p, dtype=f32, device=dev)
    cl, threads = _geometry or pick_geometry(W, p)
    m8 = cuda_nmf._as_u8(mask)
    act8 = None if gene_active is None else cuda_nmf._as_u8(gene_active)
    u0c = None if u0 is None else u0.to(f32).contiguous()
    sc = None if scale is None else scale.to(f32).contiguous()
    # Scratch and converted inputs may be dropped as soon as this returns:
    # the caching allocator reuses a block only for work queued later on
    # this same stream, after the kernel.
    X = torch.empty(cuda_nmf.scratch_shape(G, p, W, "stream"), dtype=f32,
                    device=dev)  # scratch
    K = torch.empty((G, p), dtype=f32, device=dev)
    E = torch.empty((G, W), dtype=f32, device=dev)
    u = torch.empty((G, p), dtype=f32, device=dev)
    if G == 0:
        return K, E, u
    ptr = cuda_nmf._ptr
    ws, slots = cuda_nmf.kernel_workspace(G, p, dev, "stream")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = get_lib().dn_nmf_streamed(
            F.data_ptr(), int(F.dtype == torch.int16), m8.data_ptr(),
            ptr(act8), ptr(sc), ptr(u0c), X.data_ptr(), K.data_ptr(),
            E.data_ptr(), u.data_ptr(), G, p, W, int(nmf_iter),
            int(power_iters_cold), int(power_iters_warm),
            int(power_warm_plain), cl, threads, ptr(ws), slots, stream)
    check_launch(code, "dn_nmf_streamed")
    stream_launches += 1
    if p > cuda_nmf.WIDE_MAX_P:
        stream_panel_launches += 1
        stream_panel_cluster_launches += cuda_nmf.panel_cluster(p, "stream")
        stream_panel_phase_launches += cuda_nmf.panel_phase(p)
    elif p > cuda_nmf.NARROW_MAX_P:
        stream_wide_launches += 1
    return K, E, u


def scaled_quotients_cuda(raw: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(p, n) float32 quotients ``raw[k] / scale[i]`` computed on the card by
    the device function the int16 + scale sweeps of csrc/stream.cuh use (a
    hoisted reciprocal and two corrections): the probe of the check that it
    equals the IEEE divide for every int16 numerator.  CUDA tensors only."""
    from degnorm_tpu_torch.ops.build import check_launch, get_lib
    if raw.device.type != "cuda" or raw.dtype != torch.int16:
        raise ValueError("scaled_quotients_cuda: raw must be a CUDA int16 "
                         "tensor")
    raw = raw.contiguous().view(-1)
    sc = scale.to(torch.float32).contiguous()
    out = torch.empty((sc.numel(), raw.numel()), dtype=torch.float32,
                      device=raw.device)
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = get_lib().dn_scaled_quotients(
            raw.data_ptr(), sc.data_ptr(), out.data_ptr(), raw.numel(),
            sc.numel(), stream)
    check_launch(code, "dn_scaled_quotients")
    return out


# --------------------------------------------------------------------------
# kernel 4c: the NMF loop of a column-sharded bucket, cut at its reductions
# --------------------------------------------------------------------------

def nmf_masked_colsharded_plain(
    F: torch.Tensor,
    mask: torch.Tensor,
    cols,
    *,
    nmf_iter: int,
    power_iters_cold: int = 30,
    power_iters_warm: int = 6,
    power_warm_plain: int = 0,
    gene_active: Optional[torch.Tensor] = None,
    u0: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
    nmf_tol: float = 0.0,
    method: str = "power",
):
    """Plain version of kernel 4c, a step generator: the loop of
    ``nmf_masked_streamed_plain`` on one shard's columns of every gene
    (``cols``: ``parallel/seqpar.py::Columns``), each p x p Gram summed
    across the shards before its power step, so that u, s and K are whole
    and the same on every shard.  ``nmf_tol`` > 0: the adaptive loop of
    ``cuda_nmf.nmf_masked_plain`` (the JAX package's XLA path honours it at
    any width); ``method="eigh"``: u from the summed Gram's
    eigendecomposition.  Returns (K, E, u): E over the shard's columns;
    genes outside ``gene_active`` return zeros."""
    from degnorm_tpu_torch.core.linalg import (_EPS, _dominant, _gram,
                                               _scale_of)
    A0 = _a0(F, mask, scale)
    G = A0.shape[0]
    step = 1.0 / (nmf_iter ** 0.5) if nmf_iter else 0.0
    gv = "gpw,gp->gw"
    B = yield from cols.sum_(_gram(A0))
    u = _dominant(B, u0, A0, power_iters_cold, 0, method)
    v = torch.einsum(gv, A0, u)
    X = A0.clone()
    if nmf_tol > 0:
        # the (K, E) carry; a gene freezes after the first iteration with
        # max|dK| <= nmf_tol * max|K| (cuda_nmf._adaptive_loop)
        s = _scale_of(B, u)
        K, E = u * s[:, None], v / (s[:, None] + _EPS)
        done = torch.zeros(G, dtype=torch.bool, device=A0.device)
        live = (torch.ones_like(done) if gene_active is None
                else gene_active.to(torch.bool))
        for _ in range(nmf_iter):
            if not (yield (live & ~done).any()):
                break
            Xn = outer_product(K, E)
            Xn.sub_(A0).mul_(step)
            torch.sub(X, Xn, out=Xn)
            torch.maximum(Xn, A0, out=Xn)
            B = yield from cols.sum_(_gram(Xn))
            un = _dominant(B, u, Xn, power_iters_warm, power_warm_plain,
                           method)
            sn = _scale_of(B, un)
            Kn = un * sn[:, None]
            En = torch.einsum(gv, Xn, un) / (sn[:, None] + _EPS)
            keep = done[:, None]
            Xn[done] = X[done]
            X = Xn
            Kn = torch.where(keep, K, Kn)
            En = torch.where(keep, E, En)
            un = torch.where(keep, u, un)
            delta = (Kn - K).abs().amax(dim=1)
            ref = torch.clamp_min(Kn.abs().amax(dim=1), 1e-30)
            done = done | (delta <= nmf_tol * ref)
            K, E, u = Kn, En, un
    else:
        for _ in range(nmf_iter):
            est = outer_product(u, v)
            est.sub_(A0).mul_(step)
            torch.maximum(X.sub_(est), A0, out=X)
            B = yield from cols.sum_(_gram(X))
            u = _dominant(B, u, X, power_iters_warm, power_warm_plain, method)
            v = torch.einsum(gv, X, u)
        s = _scale_of(B, u)
        K, E = u * s[:, None], v / (s[:, None] + _EPS)
    if gene_active is not None:
        act = gene_active.to(A0.dtype)[:, None]
        K, E, u = K * act, E * act, u * act
    return K, E, u


def nmf_masked_colsharded_cuda(
    F: torch.Tensor,
    mask: torch.Tensor,
    cols,
    *,
    nmf_iter: int,
    power_iters_cold: int = 30,
    power_iters_warm: int = 6,
    power_warm_plain: int = 0,
    gene_active: Optional[torch.Tensor] = None,
    u0: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
    nmf_tol: float = 0.0,
    method: str = "power",
    _geometry: Optional[Tuple[int, int]] = None,
):
    """Kernel wrapper with ``nmf_masked_colsharded_plain``'s signature, a
    step generator (csrc/stream_cols.cu): launch (a) writes X = A0 and each
    gene's partial Gram of A0 over the shard's columns into this shard's
    slot of the group's buffer (``cols.partials``); each of ``nmf_iter``
    launches (b) sums every shard's partial of the last launch
    (``cols.gather_``: unsummed, in shard order), runs the power step on
    the sum (every shard the same one, so u is bit-equal everywhere), one
    merged sweep of the shard's columns and the next partial Gram; a
    finishing launch refits u and s and writes K and the shard's columns of
    E.  ``nmf_iter + 2`` launches and ``nmf_iter + 1`` gathers a call; past
    ``cuda_nmf.NARROW_MAX_P`` each sweep and the finish are two kernels,
    the power step once a gene and then the blocks, ``2 nmf_iter + 3``
    (``cols_calls``).
    ``nmf_tol > 0`` launches the adaptive instances
    (csrc/stream_cols_tol.cu): a gene freezes on the summed Gram's refit, as
    in the plain version, and adds zero partials from then on.  Takes
    float32 coverage, or int16 coverage with or without ``scale``, of any
    width, 2 <= p <= ``cuda_nmf.COLS_MAX_P`` (128; above
    ``cuda_nmf.NARROW_MAX_P`` the wide instances of
    csrc/stream_cols_wide.cuh, a block's tiles streamed through a ring of
    stages by a producer warp and the Gram's upper triangle on the tensor
    cores); a gene outside ``gene_active`` writes zero
    partials, so every shard reduces as often.  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises
    (``method="eigh"`` has no kernel: ``core/nmf.py`` routes it to the plain
    version).  A gene's columns are spread over the blocks of
    ``pick_cols_geometry`` for the bucket's genes (``cols.genes``);
    results differ between geometries by float32 summation order alone and
    are the same bits for the same geometry.  ``_geometry`` overrides
    (blocks a gene, threads): the timing sweep of ``chip_smoke.py`` passes
    it, nothing else does."""
    kwargs = dict(nmf_iter=nmf_iter, power_iters_cold=power_iters_cold,
                  power_iters_warm=power_iters_warm,
                  power_warm_plain=power_warm_plain, gene_active=gene_active,
                  u0=u0, scale=scale, nmf_tol=nmf_tol, method=method)
    if F.device.type == "cpu":
        return (yield from nmf_masked_colsharded_plain(F, mask, cols,
                                                       **kwargs))
    global colsharded_launches, colsharded_tol_launches
    global colsharded_wide_launches
    from degnorm_tpu_torch.ops.build import check_launch, get_lib
    name = "nmf_masked_colsharded_cuda"
    if method != "power":
        raise NotImplementedError(f"{name}: method={method!r} has no kernel")
    cuda_nmf.check_coverage_input(F, name, int16_ok=True,
                                  max_p=cuda_nmf.COLS_MAX_P)
    G, p, W = F.shape
    if scale is not None and F.dtype != torch.int16:
        raise NotImplementedError(
            f"{name}: float32 coverage with scale is not taken on a CUDA "
            "tensor; divide it first and pass no scale")
    f32, i32, dev = torch.float32, torch.int32, F.device
    nb, threads = _geometry or pick_cols_geometry(cols.genes, p, W)
    m8 = cuda_nmf._as_u8(mask)
    act8 = None if gene_active is None else cuda_nmf._as_u8(gene_active)
    sc = None if scale is None else scale.to(f32).contiguous()
    i16 = int(F.dtype == torch.int16)
    # every buffer once a call: X, the outputs, u and s by sweep parity
    # (a block reads the last launch's while the gene's first block writes
    # this one's), the gene's last active column and its ticket, the
    # blocks' partials where a gene has several
    X = torch.empty((G, p, W), dtype=f32, device=dev)            # scratch
    K = torch.empty((G, p), dtype=f32, device=dev)
    E = torch.empty((G, W), dtype=f32, device=dev)
    u = torch.empty((G, p), dtype=f32, device=dev)
    if G == 0:
        return K, E, u
    ng = packed_gram_floats(p)
    slots = cols.partials((G, ng), dev)          # (2, shards, G, ng)
    us = torch.empty((2, G, p), dtype=f32, device=dev)
    counts = torch.zeros((2, G), dtype=i32, device=dev)  # ncols, tickets
    bpart = (torch.empty((G, nb, ng), dtype=f32, device=dev) if nb > 1
             else None)
    tol = float(nmf_tol)
    wide = p > cuda_nmf.NARROW_MAX_P
    per = cols_step_kernels(p)  # kernels a sweep's and the finish's launch
    # the adaptive instances carry s and the frozen genes between launches;
    # the wide finish hands s from its power step to its E kernel (row 2)
    ss = done = None
    if tol > 0 or wide:
        ss = torch.empty((3, G), dtype=f32, device=dev)
    if tol > 0:
        done = torch.zeros(G, dtype=torch.uint8, device=dev)
    ncols, tickets = counts[0], counts[1]
    me, S = cols.shard, cols.count
    # the pointers of a sweep, taken once a call: the host's share of a
    # sweep is the launch and the gather ask alone
    lib, ptr = get_lib(), cuda_nmf._ptr
    views = (slots[0], slots[1])
    mine = (slots[0, me].data_ptr(), slots[1, me].data_ptr())
    u_at = (us[0].data_ptr(), us[1].data_ptr())
    s_at = ((None, None) if tol <= 0
            else (ss[0].data_ptr(), ss[1].data_ptr()))
    s_fin = ss[2].data_ptr() if wide else None
    f_p, m_p, a_p, sc_p, x_p = (F.data_ptr(), m8.data_ptr(), ptr(act8),
                                ptr(sc), X.data_ptr())
    b_p, t_p, n_p, d_p = (ptr(bpart), tickets.data_ptr(), ncols.data_ptr(),
                          ptr(done))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        check_launch(lib.dn_cols_gram(
            f_p, i16, m_p, a_p, sc_p, x_p, mine[0], b_p, t_p, n_p, G, p, W,
            nb, threads, stream), "dn_cols_gram")
    colsharded_launches += 1
    colsharded_wide_launches += wide
    parts = yield from cols.gather_(views[0])
    u_in = None if u0 is None else u0.to(f32).contiguous()
    u_p, s_p = ptr(u_in), None
    for it in range(nmf_iter):
        q = (it + 1) & 1
        n_sq, n_plain = ((power_iters_cold, 0) if it == 0
                         else (power_iters_warm, power_warm_plain))
        with torch.cuda.device(dev):
            check_launch(lib.dn_cols_sweep(
                f_p, i16, m_p, a_p, sc_p, x_p, parts.data_ptr(), S, n_p, u_p,
                u_at[q], mine[q], b_p, t_p, s_p, s_at[q], d_p, tol, it, G, p,
                W, int(nmf_iter), int(n_sq), int(n_plain), nb, threads,
                stream), "dn_cols_sweep")
        colsharded_launches += per
        colsharded_tol_launches += per * (tol > 0)
        colsharded_wide_launches += per * wide
        u_p, s_p = u_at[q], s_at[q]
        parts = yield from cols.gather_(views[q])
    n_sq, n_plain = ((power_iters_cold, 0) if nmf_iter == 0
                     else (power_iters_warm, power_warm_plain))
    with torch.cuda.device(dev):
        check_launch(lib.dn_cols_finish(
            m_p, a_p, x_p, parts.data_ptr(), S, n_p, u_p, K.data_ptr(),
            E.data_ptr(), u.data_ptr(), s_p, s_fin, d_p, tol, G, p, W,
            int(n_sq), int(n_plain), nb, threads, stream), "dn_cols_finish")
    colsharded_launches += per
    colsharded_tol_launches += per * (tol > 0)
    colsharded_wide_launches += per * wide
    return K, E, u
