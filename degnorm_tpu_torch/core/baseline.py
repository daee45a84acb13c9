"""Batched masked baseline selection — the per-gene trimming loop of DegNorm
for a whole padded bucket.

Counterpart of ``degnorm_tpu/core/baseline.py`` (itself the batched re-design
of reference ``GeneNMFOA.baseline_selection``, ``degnorm/nmf.py:189-372``).
A (G, p, W) bucket advances together through at most ``bins - min_bins``
trim rounds with every early exit of the reference as a per-gene ``active``
flag:

  * exact-approximation exit (nmf.py:286-287)
  * svds ValueError on < 2 surviving columns (nmf.py:306-310)
  * all-zero fitted sample (nmf.py:315-316)
  * bin-count / gene-length floors (nmf.py:323-324)

Column deletion becomes bin masking: trim bins are consecutive runs of the
high-coverage column *ranks* with chunk size ceil(n/bins), and a dropped bin
deactivates its columns.  The residuals of round r+1 are computed against
the estimate of round r clipped up to F, but round 1 uses the *unclipped*
initial estimate (nmf.py:247); the trim loop carries a ``clipped`` flag.

The trim loop itself lives in ``ops/cuda_trim.py``: one fused CUDA kernel
for a bucket inside its gate, else a Python ``while`` over tensors whose NMF
per round is the plain version or, with the kernels on, a kernel launch (the
unfused loop of a wide bucket).

On a column-sharded bucket (``parallel/seqpar.py``) F is one shard's
columns of every gene: each reduction over the columns goes through the
shard's ``Columns`` object (a partial here, reduced across the shards), so
every shard holds the same per-gene state; a column-sharded bucket always
takes the unfused loop, as the JAX package's XLA path does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from degnorm_tpu_torch.config import (EngineConfig, NMFConfig,
                                     nmf_tol_applies, trim_fast_applies)
from degnorm_tpu_torch.core.linalg import (masked_rowsum, median_mid,
                                           outer_product)
from degnorm_tpu_torch.core.nmf import nmf_masked_steps
from degnorm_tpu_torch.ops import cuda_trim
from degnorm_tpu_torch.parallel.seqpar import ONE_DEVICE, Columns

# estimate materialization kinds (see BucketResult.est_kind)
EST_INPUT = 0    # estimate is the (scale-adjusted) input F itself
EST_CLIP = 1     # estimate = max(K·E, F) on valid columns
EST_RAW = 2      # estimate = K·E unclipped


class BucketResult(NamedTuple):
    rho: torch.Tensor          # (G, p) DI scores, pre-clip
    ran_bs: torch.Tensor       # (G,) bool: entered the trim loop this iteration
    est_K: torch.Tensor        # (G, p) final estimate row factor
    est_E: torch.Tensor        # (G, W) final estimate column factor
    est_kind: torch.Tensor     # (G,) int8, one of EST_INPUT/EST_CLIP/EST_RAW
    bailed: torch.Tensor       # (G,) bool: returned defaults before NMF
    n_hi: torch.Tensor         # (G,) int32 high-coverage column count
    rounds_active: torch.Tensor  # (G,) int32 trim rounds each gene stayed active


def _floor_abs_k(K: torch.Tensor) -> torch.Tensor:
    """abs(K) with entries < 1e-5 replaced by the smallest valid entry
    (reference nmf.py:329-330,361-362).  If no entry is valid the reference
    crashes on an empty min; we clamp to 1e-5 instead."""
    Kq = K.abs()
    valid = Kq >= 1e-5
    inf = torch.full_like(Kq, float("inf"))
    min_valid = torch.where(valid, Kq, inf).amin(dim=1)
    min_valid = torch.where(torch.isfinite(min_valid), min_valid,
                            torch.full_like(min_valid, 1e-5))
    return torch.where(valid, Kq, min_valid[:, None])


def _envelope(F: torch.Tensor, Kq: torch.Tensor, col_mask_f: torch.Tensor) -> torch.Tensor:
    """E[w] = max_j F[j, w] / Kq[j] on active columns, 0 elsewhere
    (reference nmf.py:333,363)."""
    return (F / Kq[:, :, None]).amax(dim=1) * col_mask_f


class TrimInputs(NamedTuple):
    """Everything ``baseline_select_bucket`` computes before the trim loop:
    the masks and bail-outs, the initial NMF, and the trim loop's inputs."""
    Fm: torch.Tensor           # (G, p, W) length-masked coverage
    lm_f: torch.Tensor         # (G, W) length mask in the compute dtype
    hi: torch.Tensor           # (G, W) bool high-coverage columns
    n_hi: torch.Tensor         # (G,) int32
    rowsum_start: torch.Tensor  # (G, p)
    K0: torch.Tensor
    E0: torch.Tensor
    u0: torch.Tensor
    rho0: torch.Tensor
    bailed: torch.Tensor       # (G,) bool
    entered: torch.Tensor      # (G,) bool
    bin_id: torch.Tensor       # (G, W) int32, B = padding sentinel
    bin_count: torch.Tensor    # (G, B)
    n_bins0: torch.Tensor      # (G,) int32
    active0: torch.Tensor      # (G,) bool


def _nmf_kwargs(nmf_cfg: NMFConfig, eng_cfg: EngineConfig) -> dict:
    return dict(
        nmf_iter=nmf_cfg.nmf_iter,
        power_iters_cold=eng_cfg.power_iters_cold,
        power_iters_warm=eng_cfg.power_iters_warm,
        power_warm_plain=eng_cfg.power_warm_plain,
    )


def trim_inputs(*args, **kwargs) -> TrimInputs:
    """``trim_inputs_steps`` run to its end, with its arguments."""
    return cuda_trim.run_steps([trim_inputs_steps(*args, **kwargs)])[0]


def trim_inputs_steps(
    F: torch.Tensor,
    len_mask: torch.Tensor,
    nmf_cfg: NMFConfig,
    eng_cfg: EngineConfig,
    ds_start: Optional[torch.Tensor] = None,
    F_raw: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
    bucket_genes: Optional[int] = None,
    cols: Columns = ONE_DEVICE,
):
    """High-coverage and downsample masks, bail-outs, the initial NMF and
    the rank bins (reference nmf.py:220-271), as a step generator.
    ``F_raw``/``scale``, ``bucket_genes``, ``cols``: see
    ``baseline_select_steps``.  Returns a ``TrimInputs``."""
    G, p, W = F.shape
    dtype = F.dtype
    dev = F.device
    B = nmf_cfg.bins
    lm_f = len_mask.to(dtype)
    # Every consumer reads F only on valid columns, so the masked copy
    # stands in for F everywhere (one (G, p, W) tensor instead of two).
    Fm = F * lm_f[:, None, :]

    # ---- high-coverage mask (nmf.py:66-76,220) ----
    colmax = Fm.amax(dim=1)                            # (G, W)
    gmax = yield from cols.max_(colmax.amax(dim=1))    # (G,)
    hi = (colmax > 0.1 * gmax[:, None]) & len_mask

    # ---- systematic downsampling (nmf.py:222-227,408-426) ----
    if nmf_cfg.downsample_rate > 1:
        if ds_start is None:
            raise ValueError("ds_start required when downsampling")
        # global column numbers: a column shard starts at its offset
        idx = torch.arange(cols.offset, cols.offset + W, dtype=torch.int32,
                           device=dev)[None, :]
        ds_mask = (idx % nmf_cfg.downsample_rate) == ds_start[:, None]
        hi = hi & ds_mask

    hi_here = hi.sum(dim=1)
    n_hi = (yield from cols.sum_(hi_here)).to(torch.int32)   # (G,)

    # ---- bail-outs before NMF (nmf.py:232-242) ----
    bail_low = n_hi < nmf_cfg.effective_min_high_coverage
    rowsum_start = yield from cols.sum_(masked_rowsum(Fm, hi.to(dtype)))
    bail_zero_row = (rowsum_start > 0).sum(dim=1) < p

    # ---- initial NMF, unclipped DI scores (nmf.py:245-258) ----
    K0, E0, u0 = yield from nmf_masked_steps(
        Fm, hi, gene_active=~(bail_low | bail_zero_row),
        use_kernels=eng_cfg.use_kernels, F_raw=F_raw, scale=scale,
        nmf_tol=eng_cfg.nmf_tol, method=eng_cfg.rank1_method,
        bucket_genes=bucket_genes, cols=cols, **_nmf_kwargs(nmf_cfg, eng_cfg))
    est_rs0 = K0 * (yield from cols.sum_(E0.sum(dim=1)))[:, None]
    rho0 = 1 - rowsum_start / (est_rs0 + 1)
    bail_nonconv = median_mid(1 - rho0, dim=1) > 1
    bailed = bail_low | bail_zero_row | bail_nonconv

    entered = (~bailed) & (n_hi >= nmf_cfg.min_gene_len) \
        & (rho0.amin(dim=1) <= 0.2)
    if nmf_cfg.skip_baseline_selection:
        entered = torch.zeros_like(entered)

    # ---- trim bins over column ranks (utils.py:176-192, nmf.py:269-271) ----
    csize = torch.clamp_min((n_hi + B - 1) // B, 1)    # (G,)
    csum = torch.cumsum(hi, dim=1)
    if cols.sharded:
        # a column shard's ranks continue the shards before it: a trim bin
        # may straddle a shard boundary
        csum = csum + (yield from cols.exclusive_scan(hi_here))[:, None]
    rank = csum.to(torch.int32) - 1
    bin_id = torch.where(hi, rank // csize[:, None],
                         torch.full_like(rank, B))     # B == padding sentinel
    bin_ids = torch.arange(B, dtype=torch.int32, device=dev)
    # bins are rank-contiguous runs of length csize: closed-form counts.
    bin_count = torch.minimum(
        torch.clamp_min(n_hi[:, None] - bin_ids[None, :] * csize[:, None], 0),
        csize[:, None]).to(dtype)                      # (G, B)
    n_bins0 = ((n_hi + csize - 1) // csize).to(torch.int32)
    active0 = entered & (rho0.amax(dim=1) > 0.1)       # nmf.py:273
    return TrimInputs(Fm=Fm, lm_f=lm_f, hi=hi, n_hi=n_hi,
                      rowsum_start=rowsum_start, K0=K0, E0=E0, u0=u0,
                      rho0=rho0, bailed=bailed, entered=entered,
                      bin_id=bin_id, bin_count=bin_count, n_bins0=n_bins0,
                      active0=active0)


def trim_kwargs(nmf_cfg: NMFConfig, eng_cfg: EngineConfig) -> dict:
    """Keyword arguments of the trim loop (plain or kernel) for a config."""
    return dict(
        power_iters_resume=eng_cfg.power_iters_resume,
        max_rounds=nmf_cfg.max_trim_rounds,
        min_bins=nmf_cfg.min_bins,
        min_gene_len=nmf_cfg.min_gene_len,
        **_nmf_kwargs(nmf_cfg, eng_cfg))


def baseline_select_bucket(*args, **kwargs) -> BucketResult:
    """``baseline_select_steps`` run to its end (``cuda_trim.run_steps``),
    with its arguments."""
    return cuda_trim.run_steps([baseline_select_steps(*args, **kwargs)])[0]


def baseline_select_steps(
    F: torch.Tensor,
    len_mask: torch.Tensor,
    nmf_cfg: NMFConfig,
    eng_cfg: EngineConfig,
    ds_start: Optional[torch.Tensor] = None,
    with_estimates: bool = True,
    F_raw: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
    bucket_genes: Optional[int] = None,
    cols: Columns = ONE_DEVICE,
):
    """Run baseline selection for every gene in a padded bucket, as a step
    generator (``cuda_trim.run_steps``): the unfused trim loop yields its
    host reads.  Returns a ``BucketResult``.

    Args:
      F: (G, p, W) scale-adjusted coverage.
      len_mask: (G, W) bool validity mask (True on the first L_i columns).
      nmf_cfg / eng_cfg: configuration.
      ds_start: (G,) int32 systematic-sampling start offsets in
        [0, downsample_rate); required iff downsample_rate > 1.
      F_raw/scale: the raw (unadjusted, typically int16) device coverage and
        the per-sample scale vector with F == F_raw / scale: the streamed NMF
        kernel of a wide bucket reads it at half the bytes (core/nmf.py).
      bucket_genes: where F is one shard of a bucket (parallel/), the whole
        bucket's gene count: the NMF kernel's launch rule reads it, so the
        shard launches as the whole bucket would and gives its bits.
      cols: where F holds one shard's columns of every gene of a
        column-sharded bucket (``parallel/seqpar.py``), the shard's
        ``Columns``: every reduction over the columns is reduced across the
        bucket's shards, and the loop is the unfused one, its NMF the
        column-sharded route of ``core/nmf.py``.  ``ONE_DEVICE`` otherwise.
    """
    ti = yield from trim_inputs_steps(F, len_mask, nmf_cfg, eng_cfg, ds_start,
                                      F_raw, scale, bucket_genes, cols)
    targs = (ti.Fm, ti.bin_id, ti.bin_count, ti.K0, ti.E0, ti.rho0, ti.u0,
             ti.n_hi, ti.n_bins0, ti.active0)
    tkw = trim_kwargs(nmf_cfg, eng_cfg)
    # the fused loop: one kernel launch a bucket inside its gate (eigh runs
    # the plain unfused loop, as the JAX package's XLA twin does); the
    # opt-in modes apply where the JAX package's own gates say they do
    fused = (eng_cfg.fuse_trim and eng_cfg.rank1_method == "power"
             and not cols.sharded
             and cuda_trim.fused_trim_supported(F.shape, F.dtype))
    fast = eng_cfg.trim_fast and fused and trim_fast_applies(F.shape)
    if fused and (eng_cfg.use_kernels or fast):
        # the whole loop in one kernel launch (plain version on the CPU);
        # the plain fit of a trim_fast bucket runs the fused loop's plain
        # version, whose rounds the unfused loop does not have
        fn = (cuda_trim.trim_loop_cuda if eng_cfg.use_kernels
              else cuda_trim.trim_loop_plain)
        tol = eng_cfg.nmf_tol if nmf_tol_applies(F.shape) else 0.0
        K_t, rho_t, ran_bs, rounds_active = fn(
            *targs, trim_fast=fast, nmf_tol=tol, **tkw)
    else:
        # the unfused loop: a Python while over tensors with one NMF per
        # round through nmf_masked (a kernel launch with the kernels on),
        # resumed from the previous round's left vector
        resume_kwargs = dict(
            _nmf_kwargs(nmf_cfg, eng_cfg),
            power_iters_cold=(eng_cfg.power_iters_resume
                              or eng_cfg.power_iters_cold))

        def round_nmf(col_mask, gene_active, u_prev):
            # a step generator on a column shard (the loop runs it)
            return nmf_masked_steps(ti.Fm, col_mask, gene_active=gene_active,
                                    u0=u_prev, use_kernels=eng_cfg.use_kernels,
                                    F_raw=F_raw, scale=scale,
                                    nmf_tol=eng_cfg.nmf_tol,
                                    method=eng_cfg.rank1_method,
                                    bucket_genes=bucket_genes, cols=cols,
                                    **resume_kwargs)

        K_t, rho_t, ran_bs, rounds_active = yield from \
            cuda_trim.trim_loop_steps(*targs, nmf_fn=round_nmf, cols=cols,
                                      **tkw)

    return (yield from _finalize_bucket(
        ti.Fm, ti.lm_f, ti.hi.to(F.dtype), len_mask, ti.K0, ti.E0, ti.rho0,
        ti.rowsum_start, ti.n_hi, ti.bailed, ti.entered, K_t, rho_t, ran_bs,
        rounds_active, with_estimates, cols))


def _finalize_bucket(Fm, lm_f, hi_f, len_mask, K0, E0, rho0, rowsum_start,
                     n_hi, bailed, entered, K_t, rho_t, ran_bs,
                     rounds_active, with_estimates, cols: Columns):
    """Post-trim-loop refit / revert (nmf.py:327-365), as a step generator
    (its sums over the columns go through ``cols``); consumes only K, rho,
    ran_bs and rounds_active from the loop.  Returns a ``BucketResult``,
    whose ``est_E`` holds this shard's columns."""
    G, p, W = Fm.shape

    # ---- post-loop refit / revert (nmf.py:327-353) ----
    conv = rho_t.amax(dim=1) < 0.2
    Kq = _floor_abs_k(K_t)
    E_env = _envelope(Fm, Kq, hi_f)
    est_rs_env = Kq * (yield from cols.sum_(E_env.sum(dim=1)))[:, None]
    rho_env = 1 - rowsum_start / (est_rs_env + 1)
    inflate = rho_env.amax(dim=1) > 0.9

    use_env = entered & conv & ~inflate
    use_revert = entered & (~conv | inflate)

    est0_clip_rs = yield from cols.sum_(masked_rowsum(
        torch.maximum(outer_product(K0, E0), Fm), hi_f))
    rho_rev = 1 - rowsum_start / (est0_clip_rs + 1)

    rho_out = torch.where(
        use_env[:, None], rho_env,
        torch.where(use_revert[:, None], rho_rev,
                    torch.where(bailed[:, None], torch.zeros_like(rho0),
                                rho0)))

    # ---- estimate factors for the output contract (nmf.py:355-365) ----
    # "latest K" for the full-width refit: envelope K for converged genes,
    # the pre-trim K0 otherwise.
    K_fin = torch.where(use_env[:, None], Kq, K0)
    E_fin = torch.where(use_env[:, None], E_env, E0)

    L = (yield from cols.sum_(len_mask.sum(dim=1))).to(torch.int32)
    needs_fw = (~bailed) & (n_hi < L)
    Kq2 = _floor_abs_k(K_fin)
    est_K = torch.where(needs_fw[:, None], Kq2, K_fin)
    kind = torch.full((G,), EST_RAW, dtype=torch.int8, device=Fm.device)
    kind = torch.where(needs_fw | use_revert,
                       torch.full_like(kind, EST_CLIP), kind)
    est_kind = torch.where(bailed, torch.full_like(kind, EST_INPUT), kind)
    if with_estimates:
        E_fw = _envelope(Fm, Kq2, lm_f)
        est_E = torch.where(needs_fw[:, None], E_fw, E_fin)
    else:
        # intermediate iterations only consume rho and the flags
        est_E = torch.zeros((G, 0), dtype=Fm.dtype, device=Fm.device)

    return BucketResult(rho=rho_out, ran_bs=ran_bs, est_K=est_K,
                        est_E=est_E, est_kind=est_kind, bailed=bailed,
                        n_hi=n_hi, rounds_active=rounds_active)


def materialize_estimate(F_adj, length, est_K, est_E, est_kind):
    """Rebuild one gene's dense estimated coverage matrix (p x L) from the
    factor form returned by ``baseline_select_bucket`` (host-side, numpy).
    ``F_adj`` is the scale-adjusted input (p x L)."""
    if est_kind == EST_INPUT:
        return np.asarray(F_adj[:, :length])
    KE = np.outer(est_K, est_E[:length])
    if est_kind == EST_CLIP:
        return np.maximum(KE, F_adj[:, :length])
    return KE
