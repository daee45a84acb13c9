"""The baseline-selection trim loop: CUDA kernel wrapper and its plain
PyTorch version.

Counterpart of ``degnorm_tpu/ops/pallas_trim.py`` (``trim_loop_pallas``).
The plain version is a Python ``while`` over tensors with the semantics of
the JAX package's ``lax.while_loop`` (``core/baseline.py``); the kernel
(``csrc/trim.cu``) runs the same loop per gene in one launch.  The same
Python loop is also the unfused trim loop of a bucket outside the fused
kernel's gate: its ``nmf_fn`` hook then launches an NMF kernel per round.
The trim state's E factor is never consumed after the loop, so neither
returns it.
"""
from __future__ import annotations

import inspect
from typing import Callable, Iterable, List, Optional, Tuple

import torch

from degnorm_tpu_torch.core.linalg import masked_rowsum, outer_product
from degnorm_tpu_torch.ops import cuda_nmf
from degnorm_tpu_torch.parallel.seqpar import ONE_DEVICE, Columns, Reduction

# Launch counters (plain ints): one is added where the kernel is launched.
# ``trim_fast_launches`` and ``trim_tol_launches`` count the launches that
# run the kernel's trim_fast or nmf_tol branch (in ``trim_launches`` too).
trim_launches = 0
trim_fast_launches = 0
trim_tol_launches = 0
# the launches of the wide instances (cuda_nmf.NARROW_MAX_P < p <=
# cuda_nmf.WIDE_MAX_P: csrc/trim_wide.cuh) and of the panel instances (p >
# cuda_nmf.WIDE_MAX_P: csrc/trim_panel.cu), in the counts above too, by
# branch
trim_wide_launches = 0
trim_wide_fast_launches = 0
trim_wide_tol_launches = 0
trim_panel_launches = 0
trim_panel_fast_launches = 0
trim_panel_tol_launches = 0
# ... of them, those on the phased layout past cuda_nmf.PCL_MAX_P
# (``cuda_nmf.panel_phase(p, "loop")``: every branch)
trim_panel_phase_launches = 0

MAX_BINS = cuda_nmf.TRIM_MAX_BINS    # per-bin state in shared memory


def fused_trim_supported(shape, dtype) -> bool:
    """True when the fused trim kernel takes a (G, p, W) bucket: the gate of
    the resident kernels (``cuda_nmf.kernels_supported``)."""
    return cuda_nmf.kernels_supported(shape, dtype)


def _col_active_from(bin_active: torch.Tensor, bin_id: torch.Tensor) -> torch.Tensor:
    """(G, B) bin flags -> (G, W) column flags; padding columns carry the
    sentinel id B and stay inactive."""
    pad = torch.zeros_like(bin_active[:, :1])
    return torch.gather(torch.cat([bin_active, pad], dim=1), 1, bin_id.long())


def _per_bin_sums(res: torch.Tensor, bin_id: torch.Tensor, B: int) -> torch.Tensor:
    """Per-bin sums of a (G, W) array as B masked reductions: a fixed
    summation order (a scatter-add on the GPU would use atomics)."""
    return torch.stack(
        [(res * (bin_id == b)).sum(dim=1) for b in range(B)], dim=1)


def run_steps(steps: Iterable) -> List:
    """Drive step generators to their ends and return their values, in
    order.  A step generator (``trim_loop_steps``,
    ``core/baseline.py::baseline_select_steps``) yields a device tensor
    whose host value it needs next and takes ``bool`` of it back.  Every
    generator is advanced to its next read before the host waits on any
    one: shards of a bucket on several cards all have their round queued
    while the host reads one card's ``active.any()``.

    The column shards of a bucket (``parallel/seqpar.py``) also yield a
    ``Reduction``; the shards of one bucket ask in lockstep, and each round
    of asks is answered by ``Reduction.group.combine`` (partials reduced
    across the shards) instead."""
    steps = list(steps)
    out: List = [None] * len(steps)
    asks = {}
    for i, g in enumerate(steps):
        try:
            asks[i] = next(g)
        except StopIteration as stop:
            out[i] = stop.value
    while asks:
        reduce = [i for i, a in asks.items() if isinstance(a, Reduction)]
        if reduce and len(reduce) != len(asks):
            raise RuntimeError("column shards diverged: some ask for a "
                               "reduction while others read the host")
        if reduce:
            replies = dict(zip(reduce, asks[reduce[0]].group.combine(
                [asks[i] for i in reduce])))
        else:
            replies = {i: bool(t) for i, t in asks.items()}
        nxt = {}
        for i, r in replies.items():
            try:
                nxt[i] = steps[i].send(r)
            except StopIteration as stop:
                out[i] = stop.value
        asks = nxt
    return out


def trim_loop_plain(*args, **kwargs):
    """``trim_loop_steps`` run to its end (``run_steps``): the plain version
    of the whole trim loop, with its arguments and return value."""
    return run_steps([trim_loop_steps(*args, **kwargs)])[0]


def trim_loop_steps(
    Fm: torch.Tensor,
    bin_id: torch.Tensor,
    bin_count: torch.Tensor,
    K0: torch.Tensor,
    E0: torch.Tensor,
    rho0: torch.Tensor,
    u0: torch.Tensor,
    n_hi: torch.Tensor,
    n_bins: torch.Tensor,
    active0: torch.Tensor,
    *,
    nmf_iter: int,
    power_iters_cold: int,
    power_iters_warm: int,
    power_warm_plain: int = 0,
    power_iters_resume: int = 0,
    max_rounds: int,
    min_bins: int,
    min_gene_len: int,
    trim_fast: bool = False,
    nmf_tol: float = 0.0,
    iters_out: Optional[torch.Tensor] = None,
    nmf_fn: Optional[Callable] = None,
    cols: Columns = ONE_DEVICE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the whole trim loop (reference nmf.py:273-324), as
    a step generator (``run_steps``).

    Args mirror the loop state:
      Fm: (G, p, W) length-masked scale-adjusted coverage.
      bin_id: (G, W) int32 trim-bin id per column (B = padding sentinel).
      bin_count: (G, B) column count per bin.
      K0/E0/rho0/u0: initial NMF factors, DI scores and left vectors.
      n_hi/n_bins: (G,) int32 surviving column / bin counts.
      active0: (G,) bool — genes entering the loop.
      trim_fast: the fused loop's warm-restart rounds
        (``degnorm_tpu/ops/pallas_trim.py:135-176``): a multiplier state
        X starts at Fm (lambda = 0) and each round, the first included,
        masks it to the surviving columns, refits u from it by the squared
        scheme at ``power_iters_warm`` from the carried u, runs
        n_it = max(nmf_iter // 4, 8) steps of size 1/sqrt(n_it) and builds
        K and E once.  ``nmf_tol`` does not reach these rounds.
      nmf_tol: the adaptive freeze of each plain round's NMF loop
        (``cuda_nmf.nmf_masked_plain``).
      iters_out: an int32 (G,) tensor that receives the Lagrangian
        iterations each gene ran over all its rounds, as the kernel reports
        them.
      nmf_fn: optional ``(col_mask, gene_active, u0) -> (K, E, u)`` that runs
        a round's NMF on ``Fm`` (resumed from ``u0`` at the resume count);
        the default is ``cuda_nmf.nmf_masked_plain``.  The unfused loop of
        ``core/baseline.py`` passes the kernel route here (with its own
        ``nmf_tol``; the unfused loop has no trim_fast).  It may return a
        step generator (``core/nmf.py::nmf_masked_steps``), which the loop
        runs.
      cols: the shard's columns of a column-sharded bucket
        (``parallel/seqpar.py``): the per-bin sums and the row sums over
        the columns are reduced across the bucket's shards, so every shard
        holds the same per-gene state and reads the same ``active``.

    The loop reads ``active.any()`` on the host once a round (the
    counterpart of ``lax.while_loop``'s condition): it yields that tensor
    and takes its ``bool`` back.

    Returns (K, rho, ran_bs, rounds_active).  A gene that never enters keeps
    K0, rho0, False, 0.
    """
    G, p, W = Fm.shape
    B = bin_count.shape[1]
    dtype = Fm.dtype
    bin_ids = torch.arange(B, dtype=torch.int32, device=Fm.device)
    neg_inf = torch.tensor(float("-inf"), dtype=dtype, device=Fm.device)
    power_resume = power_iters_resume or power_iters_cold
    round_iters = torch.zeros(G, dtype=torch.int32, device=Fm.device)
    iters = torch.zeros(G, dtype=torch.int32, device=Fm.device)
    if nmf_fn is not None and (trim_fast or nmf_tol):
        raise ValueError("trim_loop_plain: trim_fast and nmf_tol belong to "
                         "the fused loop; an nmf_fn carries its own")
    if trim_fast:
        Xf = Fm.clone()       # X = A0 + lambda with lambda = 0 everywhere

        def nmf_fn(col_mask, gene_active, u_prev):
            can_f = col_mask.to(dtype)[:, None, :]
            return cuda_nmf.nmf_loop_plain(
                Fm * can_f, col_mask, nmf_iter=max(nmf_iter // 4, 8),
                power_iters_cold=power_iters_warm,
                power_iters_warm=power_iters_warm,
                power_warm_plain=power_warm_plain, gene_active=gene_active,
                u0=u_prev, iters_out=round_iters, X=Xf.mul_(can_f))
    elif nmf_fn is None:
        def nmf_fn(col_mask, gene_active, u_prev):
            return cuda_nmf.nmf_masked_plain(
                Fm, col_mask, nmf_iter=nmf_iter,
                power_iters_cold=power_resume,
                power_iters_warm=power_iters_warm,
                power_warm_plain=power_warm_plain, gene_active=gene_active,
                u0=u_prev, nmf_tol=nmf_tol, iters_out=round_iters)

    K, E, rho, u = K0, E0, rho0, u0
    n_hi = n_hi.to(torch.int32)
    n_bins = n_bins.to(torch.int32)
    bin_active = bin_ids[None, :] < n_bins[:, None]
    active = active0.bool()
    ran_bs = torch.zeros(G, dtype=torch.bool, device=Fm.device)
    clipped = torch.zeros(G, dtype=torch.bool, device=Fm.device)
    rounds_active = torch.zeros(G, dtype=torch.int32, device=Fm.device)
    rounds = 0

    while rounds < max_rounds and (yield active.any()):
        ran_bs = ran_bs | active                            # nmf.py:276
        ca_f = _col_active_from(bin_active, bin_id).to(dtype)

        # worst squared relative residual per column (nmf.py:280-283);
        # round 1 uses the unclipped estimate, later rounds the clipped one.
        # (in place from here on: a wide bucket's (G, p, W) temporaries are
        # gigabytes, and the loop holds at most three at a time)
        KE = outer_product(K, E)
        KE = torch.where(clipped[:, None, None], torch.maximum(KE, Fm), KE)
        z = KE.sub_(Fm).div_(Fm + 1)
        res = z.mul_(z).amax(dim=1) * ca_f
        del KE, z
        ss_r = (yield from cols.sum_(_per_bin_sums(res, bin_id, B))) \
            / torch.clamp_min(bin_count, 1.0)
        ss_masked = torch.where(bin_active, ss_r, neg_inf)

        perfect = ss_masked.amax(dim=1) == 0.0              # nmf.py:286-287
        proceed = active & ~perfect

        # first maximum, like nanargmax: the lowest index among the maxima
        is_max = ss_masked == ss_masked.amax(dim=1, keepdim=True)
        drop = torch.where(is_max, bin_ids[None, :], B).amin(dim=1)
        drop_onehot = bin_ids[None, :] == drop[:, None]
        bin_active = torch.where(proceed[:, None], bin_active & ~drop_onehot,
                                 bin_active)
        dropped = torch.where(drop_onehot, bin_count,
                              torch.zeros_like(bin_count)).sum(dim=1)
        n_hi = torch.where(proceed, n_hi - dropped.to(torch.int32), n_hi)
        n_bins = torch.where(proceed, n_bins - 1, n_bins)

        # svds would raise ValueError below 2 columns (nmf.py:306-310):
        # stop WITHOUT refreshing factors or rho.
        run_nmf = proceed & (n_hi >= 2)
        can = _col_active_from(bin_active, bin_id)

        # cold rank-1 resumed from the previous round's left vector at the
        # reduced power_iters_resume count (same unique Perron target)
        round_iters.zero_()
        res = nmf_fn(can, run_nmf, u)
        if inspect.isgenerator(res):
            res = yield from res
        Kn, En, un = res
        iters += round_iters
        est_rs = Kn * (yield from cols.sum_(En.sum(dim=1)))[:, None]
        zero_row = est_rs.amin(dim=1) == 0.0                # nmf.py:315-316
        update_rho = run_nmf & ~zero_row

        # clip up to F, recompute DI (nmf.py:318-321)
        can_f = can.to(dtype)
        KE_clip = outer_product(Kn, En)
        torch.maximum(KE_clip, Fm, out=KE_clip)
        rs_F = yield from cols.sum_(masked_rowsum(Fm, can_f))
        rs_KE = yield from cols.sum_(masked_rowsum(KE_clip, can_f))
        del KE_clip
        rho_new = 1 - rs_F / (rs_KE + 1)

        K = torch.where(run_nmf[:, None], Kn, K)
        E = torch.where(run_nmf[:, None], En, E)
        u = torch.where(run_nmf[:, None], un, u)
        rho = torch.where(update_rho[:, None], rho_new, rho)
        clipped = clipped | update_rho

        floor_hit = (n_bins <= min_bins) | (n_hi < min_gene_len)  # nmf.py:323-324
        rounds_active = rounds_active + active.to(torch.int32)
        active = update_rho & ~floor_hit & (rho_new.amax(dim=1) > 0.1)
        rounds += 1

    if iters_out is not None:
        iters_out.copy_(iters)
    return K, rho, ran_bs, rounds_active


def trim_loop_cuda(
    Fm: torch.Tensor,
    bin_id: torch.Tensor,
    bin_count: torch.Tensor,
    K0: torch.Tensor,
    E0: torch.Tensor,
    rho0: torch.Tensor,
    u0: torch.Tensor,
    n_hi: torch.Tensor,
    n_bins: torch.Tensor,
    active0: torch.Tensor,
    *,
    nmf_iter: int,
    power_iters_cold: int,
    power_iters_warm: int,
    power_warm_plain: int = 0,
    power_iters_resume: int = 0,
    max_rounds: int,
    min_bins: int,
    min_gene_len: int,
    trim_fast: bool = False,
    nmf_tol: float = 0.0,
    iters_out: Optional[torch.Tensor] = None,
    _threads: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel wrapper with ``trim_loop_plain``'s signature: one thread block
    per gene runs the whole loop while its own gene is active
    (csrc/trim.cu; the trim_fast and nmf_tol branches are the instances of
    csrc/trim_fast.cu and csrc/trim_tol.cu; p > 32 the wide instances of
    csrc/trim_wide.cuh, p > 128 their panel instances, csrc/trim_panel.cu:
    up to ``cuda_nmf.PCL_MAX_P`` a cluster of blocks a gene, above each
    round in launches over the whole card, its NMF loop on kernel 1's
    phased layout; the host reads the count of genes going on once a
    round, and a bucket no gene enters costs one launch and one wait).  A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises.  ``_threads``
    overrides ``cuda_nmf.pick_loop_threads`` (the timing sweep of
    ``chip_smoke.py --sweep`` passes it; nothing else does)."""
    kwargs = dict(nmf_iter=nmf_iter, power_iters_cold=power_iters_cold,
                  power_iters_warm=power_iters_warm,
                  power_warm_plain=power_warm_plain,
                  power_iters_resume=power_iters_resume,
                  max_rounds=max_rounds, min_bins=min_bins,
                  min_gene_len=min_gene_len, trim_fast=trim_fast,
                  nmf_tol=nmf_tol, iters_out=iters_out)
    if Fm.device.type == "cpu":
        return trim_loop_plain(Fm, bin_id, bin_count, K0, E0, rho0, u0,
                               n_hi, n_bins, active0, **kwargs)
    global trim_launches, trim_fast_launches, trim_tol_launches
    global trim_wide_launches, trim_wide_fast_launches, trim_wide_tol_launches
    global trim_panel_launches, trim_panel_fast_launches
    global trim_panel_tol_launches, trim_panel_phase_launches
    from degnorm_tpu_torch.ops.build import check_launch, get_lib
    cuda_nmf.check_kernel_input(Fm, "trim_loop_cuda")
    G, p, W = Fm.shape
    B = bin_count.shape[1]
    if B > MAX_BINS:
        raise ValueError(f"trim_loop_cuda: bins={B} exceeds {MAX_BINS}")
    dev = Fm.device
    if iters_out is not None and (iters_out.dtype != torch.int32
                                  or iters_out.shape != (G,)
                                  or iters_out.device != dev):
        raise ValueError("trim_loop_cuda: iters_out must be an int32 (G,) "
                         "tensor on the coverage's device")
    threads = _threads or cuda_nmf.pick_loop_threads(p, W)
    f32, i32 = torch.float32, torch.int32
    bin_id_c = bin_id.to(i32).contiguous()
    bin_count_c = bin_count.to(f32).contiguous()
    K0c, rho0c, u0c = (t.to(f32).contiguous() for t in (K0, rho0, u0))
    # E is read for the first round's residuals and rewritten by every
    # round's NMF: the kernel works on a copy so the caller's E0 survives
    # (on the phased layout, past PCL_MAX_P, the copy is in its workspace)
    if cuda_nmf.panel_phase(p, "loop"):
        E = E0.to(f32).contiguous()
    else:
        E = E0.to(f32).clone(memory_format=torch.contiguous_format)
    n_hi_c = n_hi.to(i32).contiguous()
    n_bins_c = n_bins.to(i32).contiguous()
    act8 = cuda_nmf._as_u8(active0)
    # scratch: the multipliers X (with trim_fast, carried from round to
    # round: its first round starts from Fm) and the column mask
    X = torch.empty(cuda_nmf.loop_scratch_shape(G, p, W), dtype=f32,
                    device=dev)
    colmask = torch.empty((G, W), dtype=torch.uint8, device=dev)
    K = torch.empty((G, p), dtype=f32, device=dev)
    rho = torch.empty((G, p), dtype=f32, device=dev)
    ran_bs = torch.empty((G,), dtype=torch.uint8, device=dev)
    rounds_active = torch.empty((G,), dtype=i32, device=dev)
    if G == 0:
        return K, rho, ran_bs.view(torch.bool), rounds_active
    ws, slots = cuda_nmf.kernel_workspace(G, p, dev, "loop", W, B)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = get_lib().dn_trim_loop(
            Fm.data_ptr(), bin_id_c.data_ptr(), bin_count_c.data_ptr(),
            K0c.data_ptr(), E.data_ptr(), rho0c.data_ptr(), u0c.data_ptr(),
            n_hi_c.data_ptr(), n_bins_c.data_ptr(), act8.data_ptr(),
            X.data_ptr(), colmask.data_ptr(),
            K.data_ptr(), rho.data_ptr(), ran_bs.data_ptr(),
            rounds_active.data_ptr(), cuda_nmf._ptr(iters_out),
            G, p, W, B, int(nmf_iter),
            int(power_iters_resume or power_iters_cold),
            int(power_iters_warm), int(power_warm_plain),
            int(max_rounds), int(min_bins), int(min_gene_len),
            int(bool(trim_fast)), float(nmf_tol), threads,
            cuda_nmf._ptr(ws), slots, stream)
    check_launch(code, "dn_trim_loop")
    trim_launches += 1
    if trim_fast:
        trim_fast_launches += 1
    elif nmf_tol > 0:
        trim_tol_launches += 1
    if p > cuda_nmf.WIDE_MAX_P:
        trim_panel_launches += 1
        trim_panel_phase_launches += cuda_nmf.panel_phase(p, "loop")
        if trim_fast:
            trim_panel_fast_launches += 1
        elif nmf_tol > 0:
            trim_panel_tol_launches += 1
    elif p > cuda_nmf.NARROW_MAX_P:
        trim_wide_launches += 1
        if trim_fast:
            trim_wide_fast_launches += 1
        elif nmf_tol > 0:
            trim_wide_tol_launches += 1
    return K, rho, ran_bs.view(torch.bool), rounds_active
