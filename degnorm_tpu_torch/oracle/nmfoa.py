"""Golden float64 host oracle for the DegNorm NMF-OA algorithm.

This package's copy of ``degnorm_tpu/oracle/nmfoa.py`` (numpy and scipy
only; ``NMFConfig`` from this package), equal to it bit for bit
(tests/test_torch_oracle.py).  A clean-room, functional re-derivation of the
math in the reference implementation (DegNorm's ``degnorm/nmf.py`` and
``R/NMF_functions.R``), used as the parity target for the engine: on the
card, ``chip_smoke.py`` phase ``oracle`` holds the CUDA engine against it.
It fills the reference's own test gap (SURVEY.md §4): the reference has no
numeric golden tests at all.

Semantics notes (each behavior is cited into the reference so that parity
can be checked):

* ``nmf`` leaves the over-approximation clip *disabled* — the clip line is
  commented out in the reference (nmf.py:104-106) and applied selectively at
  call sites instead (nmf.py:318,345,352,365).  The *initial* DI computation
  inside baseline selection therefore uses the unclipped estimate
  (nmf.py:254).
* DI denominators always add ``+1`` (nmf.py:254,321,337 — "as per Bin's
  code").
* ``rank_one`` uses ARPACK via ``scipy.sparse.linalg.svds`` exactly like the
  reference (nmf.py:63); signs of (u, v) are arbitrary but every consumer is
  sign-invariant (K·E products) or takes ``abs(K)`` first (nmf.py:329).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy.sparse.linalg import svds

from degnorm_tpu_torch.config import NMFConfig

__all__ = [
    "rank_one",
    "nmf_oa",
    "ratio_svd",
    "high_coverage_idx",
    "chunk_size",
    "baseline_selection",
    "degnorm_fit",
    "DegNormResult",
]


def rank_one(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Truncated rank-1 SVD: returns (K, E) with K = u*s (p x 1), E = v (1 x L).

    Mirrors reference nmf.py:55-64.
    """
    u, s, vt = svds(x, k=1)
    return u * s, vt


def nmf_oa(x: np.ndarray, nmf_iter: int) -> Tuple[np.ndarray, np.ndarray]:
    """NMF-over-approximation fixed-point loop (reference nmf.py:78-102).

    Clipped-Lagrangian iteration: repeatedly refit a rank-1 approximation to
    ``x + lambda`` where ``lambda`` accumulates the negative residual, clipped
    at zero.  Returns the final (K, E) factors, possibly signed.
    """
    k, e = rank_one(x)
    if nmf_iter <= 0:
        # reference: c = 1/np.sqrt(0) -> inf with a RuntimeWarning, loop
        # skipped — the plain rank-1 factors come back
        return k, e
    est = k @ e
    lam = np.zeros_like(x)
    step = 1.0 / math.sqrt(nmf_iter)
    for _ in range(nmf_iter):
        lam = np.maximum(lam - step * (est - x), 0.0)
        k, e = rank_one(x + lam)
        est = k @ e
    return k, e


def ratio_svd(x: np.ndarray) -> np.ndarray:
    """One-shot rank-1 over-approximation: K·E clipped up to x elementwise.

    Mirrors reference nmf.py:109-121. Used only for DegNorm initialization.
    """
    k, e = rank_one(x)
    return np.maximum(k @ e, x)


def high_coverage_idx(x: np.ndarray) -> np.ndarray:
    """Positions whose per-column max exceeds 10% of the global max
    (reference nmf.py:66-76)."""
    return np.flatnonzero(x.max(axis=0) > 0.1 * x.max())


def chunk_size(n: int, n_chunks: int) -> int:
    """Chunk size used when splitting ``n`` items into ``n_chunks`` groups.

    The reference splits with ``csize = ceil(n / n_chunks)`` and emits
    consecutive runs of that size until exhaustion (utils.py:176-192) — note
    this can yield *fewer* than ``n_chunks`` chunks (e.g. 21 items into 20
    chunks gives 11 chunks of size 2).
    """
    return int(math.ceil(n / n_chunks))


def _systematic_sample(n: int, take_every: int,
                       rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Systematic column sample with a random start offset
    (reference nmf.py:408-426)."""
    r = rng if rng is not None else np.random
    if take_every >= n:
        return np.atleast_1d(int(r.choice(n)))
    start = r.choice(take_every)
    return np.arange(start, n, step=take_every, dtype=int)


def baseline_selection(
    F: np.ndarray,
    cfg: NMFConfig,
    rng: Optional[np.random.RandomState] = None,
) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Per-gene baseline-selection trimming loop (reference nmf.py:189-372).

    Takes the scale-adjusted coverage matrix ``F`` (p x L) and returns
    ``(rho, estimate, ran_baseline_selection)``.
    """
    p, L = F.shape
    rho_default = np.zeros(p)

    hi_idx = high_coverage_idx(F)
    if cfg.downsample_rate > 1:
        # intersect systematic sample with high-coverage set (nmf.py:222-227)
        if cfg.downsample_rate >= L:
            raise ValueError("Cannot downsample at a rate < 1 / length(gene)")
        ds_idx = _systematic_sample(L, cfg.downsample_rate, rng)
        hi_idx = np.intersect1d(ds_idx, hi_idx)

    n_hi = len(hi_idx)
    if n_hi < cfg.effective_min_high_coverage:      # nmf.py:232-233
        return rho_default, F, False

    hi_idx = np.sort(hi_idx)
    F_start = F[:, hi_idx].copy()
    F_bin = F_start.copy()

    if np.count_nonzero(F_bin.sum(axis=1) > 0) < p:  # nmf.py:241-242
        return rho_default, F, False

    # initial NMF on the filtered gene; *unclipped* DI scores (nmf.py:245-254)
    K, E = nmf_oa(F_bin, cfg.nmf_iter)
    KE_bin = K @ E
    K_start, E_start = K.copy(), E.copy()
    estimate = KE_bin.copy()
    rho_vec = 1 - F_bin.sum(axis=1) / (KE_bin.sum(axis=1) + 1)

    if np.nanmedian(1 - rho_vec) > 1:                # nmf.py:257-258
        return rho_default, F, False

    ran_bs = False
    if (n_hi >= cfg.min_gene_len and np.nanmin(rho_vec) <= 0.2
            and not cfg.skip_baseline_selection):    # nmf.py:265

        # bins = consecutive runs of the (downsampled) hi-cov column ranks.
        # The reference splits with chunk size ceil(n/bins), which can give
        # FEWER than `bins` bins (utils.py:176-192); replicate that.
        ncols = F_bin.shape[1]
        csize = chunk_size(ncols, cfg.bins)
        bins: List[np.ndarray] = [
            np.arange(start, min(start + csize, ncols))
            for start in range(0, ncols, csize)
        ]
        n_bins = len(bins)

        while np.nanmax(rho_vec) > 0.1:              # nmf.py:273
            ran_bs = True

            # per-column worst squared relative residual, then per-bin mean
            # (nmf.py:280-283)
            z = (KE_bin - F_bin) / (F_bin + 1)
            res_vec = np.nanmax(z ** 2, axis=0)
            ss_r = np.array([np.nanmean(res_vec[b]) for b in bins])

            if np.nanmax(ss_r) == 0:                 # nmf.py:286-287
                break

            drop = int(np.nanargmax(ss_r))
            dropped_cols = bins[drop]
            F_bin = np.delete(F_bin, dropped_cols, axis=1)
            del bins[drop]
            n_hi = F_bin.shape[1]
            # re-reference surviving bins to the shrunken matrix: bins keep
            # their sizes and stay consecutive (equivalent to reference
            # shift_bins, nmf.py:160-187,300-302)
            offset = 0
            new_bins = []
            for b in bins:
                new_bins.append(np.arange(offset, offset + b.size))
                offset += b.size
            bins = new_bins
            n_bins = len(bins)

            try:
                if min(F_bin.shape) < 2:
                    raise ValueError("svds needs k < min(shape)")
                K, E = nmf_oa(F_bin, cfg.nmf_iter)   # nmf.py:306-310
            except ValueError:
                break
            KE_bin = K @ E

            if KE_bin.sum(axis=1).min() == 0:        # nmf.py:315-316
                break

            KE_bin = np.maximum(KE_bin, F_bin)       # nmf.py:318
            rho_vec = 1 - F_bin.sum(axis=1) / (KE_bin.sum(axis=1) + 1)

            if n_bins <= cfg.min_bins or n_hi < cfg.min_gene_len:  # nmf.py:323
                break

        if np.nanmax(rho_vec) < 0.2:
            # converged: envelope refit over the *initial* hi-cov window
            # (nmf.py:327-346)
            K = np.abs(K)
            K[K < 1e-5] = K[K >= 1e-5].min()
            E = (F_start.T / K.ravel()).max(axis=1).reshape(1, -1)
            estimate = K @ E
            rho_vec = 1 - F_start.sum(axis=1) / (estimate.sum(axis=1) + 1)
            if np.nanmax(rho_vec) > 0.9:
                K, E = K_start, E_start
                estimate = np.maximum(K @ E, F_start)
                rho_vec = 1 - F_start.sum(axis=1) / (estimate.sum(axis=1) + 1)
        else:
            # not converged: revert to pre-trim factors with clip
            # (nmf.py:349-353)
            K, E = K_start, E_start
            estimate = np.maximum(K @ E, F_start)
            rho_vec = 1 - F_start.sum(axis=1) / (estimate.sum(axis=1) + 1)

    if estimate.shape[1] < L:
        # full-width envelope refit for visualization (nmf.py:358-365);
        # rho is NOT recomputed here.
        K = np.abs(K)
        K[K < 1e-5] = K[K >= 1e-5].min()
        E = (F.T / K.ravel()).max(axis=1).reshape(1, -1)
        estimate = np.maximum(K @ E, F)

    return rho_vec, estimate, ran_bs


class DegNormResult:
    """Outputs of a full DegNorm fit (attributes mirror GeneNMFOA state)."""

    def __init__(self, rho, x_adj, scale_factors, norm_factors,
                 estimates, ran_baseline_selection, x_weighted):
        self.rho = rho
        self.x_adj = x_adj
        self.scale_factors = scale_factors
        self.norm_factors = norm_factors
        self.estimates = estimates
        self.ran_baseline_selection = ran_baseline_selection
        self.x_weighted = x_weighted


def degnorm_fit(
    cov_mats: Sequence[np.ndarray],
    counts: np.ndarray,
    cfg: NMFConfig,
) -> DegNormResult:
    """Full DegNorm outer loop (reference GeneNMFOA.run, nmf.py:483-601).

    ``cov_mats``: list of (p x L_i) float arrays; ``counts``: (n x p).
    """
    n = len(cov_mats)
    p = cov_mats[0].shape[0]
    x = np.array(counts, dtype=float)
    assert x.shape == (n, p)

    ran_bs = np.zeros((n, cfg.degnorm_iter), dtype=bool)

    # ---- initialization (nmf.py:512-535) ----
    estimates = [ratio_svd(F) for F in cov_mats]
    est_sums = np.vstack([e.sum(axis=1) for e in estimates])
    cov_sums = np.vstack([F.sum(axis=1) for F in cov_mats])
    rho = 1 - cov_sums / (est_sums + 1)

    low_di = rho.max(axis=1) < 0.1
    count_sums = x[low_di, :].sum(axis=0) if low_di.any() else x.sum(axis=0)
    norm_factors = count_sums / np.median(count_sums)
    x_weighted = x / norm_factors
    scale_factors = norm_factors.copy()

    # ---- iterations (nmf.py:556-596) ----
    np.random.seed(cfg.random_state)
    x_adj = None
    for it in range(cfg.degnorm_iter):
        adj = [F / scale_factors[:, None] for F in cov_mats]

        results = [baseline_selection(Fa, cfg) for Fa in adj]
        rho = np.vstack([r[0] for r in results])
        rho = np.clip(rho, 0.0, 0.9)                  # nmf.py:398-399
        estimates = [r[1] for r in results]
        ran_bs[:, it] = [r[2] for r in results]

        x_adj = x_weighted / (1 - rho)

        # genes never baseline-selected get the sample-average DI
        # (nmf.py:148-158,578)
        non_bs = rho.max(axis=1) == 0
        if non_bs.any():
            sample_avg = 1 - x_weighted.sum(axis=0) / x_adj.sum(axis=0)
            rho[non_bs, :] = sample_avg

        x_adj = x_weighted / (1 - rho)
        col = x_adj.sum(axis=0)
        norm_factors = col / np.median(col)
        x_weighted = x_weighted / norm_factors
        scale_factors = scale_factors * norm_factors

    return DegNormResult(rho=rho, x_adj=x_adj, scale_factors=scale_factors,
                         norm_factors=norm_factors, estimates=estimates,
                         ran_baseline_selection=ran_bs, x_weighted=x_weighted)
