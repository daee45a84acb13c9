"""DegNorm outer-loop state updates.

Counterpart of ``degnorm_tpu/core/degnorm.py``: the O(n·p) global reductions
between bucket steps — the update rules of reference ``GeneNMFOA.run``
(nmf.py:483-601).  The numpy float64 functions are this package's own copy
of the host-side rules; the torch twins run the same op order in
``torch.float64`` on the engine's device (the GPU has native float64, so no
compensated two-float arithmetic is needed).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from degnorm_tpu_torch.core.linalg import median_mid


class GlobalState(NamedTuple):
    """Cross-gene DegNorm state (all numpy float64)."""
    x: np.ndarray              # (n, p) raw read counts
    x_weighted: np.ndarray     # (n, p) counts / cumulative norm factors
    x_adj: np.ndarray          # (n, p) degradation-adjusted counts
    rho: np.ndarray            # (n, p) DI scores in [0, 0.9]
    norm_factors: np.ndarray   # (p,) last iteration's norm factors
    scale_factors: np.ndarray  # (p,) cumulative coverage scale factors


class DeviceState(NamedTuple):
    """``GlobalState`` as torch.float64 tensors on the engine's device."""
    x: torch.Tensor
    x_weighted: torch.Tensor
    x_adj: torch.Tensor
    rho: torch.Tensor
    norm_factors: torch.Tensor
    scale_factors: torch.Tensor

    def to_numpy(self) -> GlobalState:
        return GlobalState(*(t.detach().cpu().numpy().astype(np.float64)
                             for t in self))


def init_state(rho_init: np.ndarray, counts: np.ndarray) -> GlobalState:
    """DegNorm initialization from ratio-SVD DI scores (nmf.py:512-535):
    norm factors come from column sums over low-DI genes (max rho < 0.1),
    falling back to all genes; read counts are depth-normalized by them."""
    x = np.array(counts, dtype=np.float64)
    low_di = rho_init.max(axis=1) < 0.1
    count_sums = x[low_di].sum(axis=0) if low_di.any() else x.sum(axis=0)
    norm_factors = count_sums / np.median(count_sums)
    x_weighted = x / norm_factors
    return GlobalState(
        x=x,
        x_weighted=x_weighted,
        x_adj=x_weighted.copy(),
        rho=np.array(rho_init, dtype=np.float64),
        norm_factors=norm_factors,
        scale_factors=norm_factors.copy(),
    )


def iteration_update(state: GlobalState, rho_raw: np.ndarray) -> GlobalState:
    """Post-baseline-selection global update (nmf.py:396-399,574-590):

    1. clip DI scores to [0, 0.9];
    2. genes that never ran baseline selection (row max == 0) receive the
       sample-average DI score (correct_di_scores, nmf.py:148-158);
    3. re-adjust weighted counts, refresh norm factors (column sums over
       their median), fold them into the cumulative scale factors.
    """
    rho = np.clip(np.array(rho_raw, dtype=np.float64), 0.0, 0.9)

    x_adj = state.x_weighted / (1 - rho)
    non_bs = rho.max(axis=1) == 0
    if non_bs.any():
        sample_avg = 1 - state.x_weighted.sum(axis=0) / x_adj.sum(axis=0)
        rho[non_bs, :] = sample_avg

    x_adj = state.x_weighted / (1 - rho)
    col = x_adj.sum(axis=0)
    norm_factors = col / np.median(col)
    x_weighted = state.x_weighted / norm_factors
    scale_factors = state.scale_factors * norm_factors

    return GlobalState(x=state.x, x_weighted=x_weighted, x_adj=x_adj,
                       rho=rho, norm_factors=norm_factors,
                       scale_factors=scale_factors)


def rho_from_ratio_svd(cov_sums: np.ndarray, est_sums: np.ndarray) -> np.ndarray:
    """Initial DI scores 1 - sum(F)/(sum(est)+1) (nmf.py:524-526)."""
    return 1 - cov_sums / (est_sums + 1)


def device_iteration_math(rho_raw: torch.Tensor, x_weighted: torch.Tensor,
                          scale_factors: torch.Tensor):
    """Torch twin of ``iteration_update`` in float64 on the inputs' device;
    op order in lockstep with it.  ``rho_raw`` may arrive in the kernels'
    float32 and is widened first, as the host rule does.

    Returns (rho, x_adj, x_weighted_new, norm_factors, scale_factors_new).
    """
    rho = torch.clamp(rho_raw.to(torch.float64), 0.0, 0.9)
    x_adj = x_weighted / (1 - rho)
    non_bs = rho.amax(dim=1) == 0
    sample_avg = 1 - x_weighted.sum(dim=0) / x_adj.sum(dim=0)
    rho = torch.where(non_bs[:, None], sample_avg[None, :], rho)
    x_adj = x_weighted / (1 - rho)
    col = x_adj.sum(dim=0)
    norm = col / median_mid(col)
    return rho, x_adj, x_weighted / norm, norm, scale_factors * norm


def device_init_state(cov_sums: torch.Tensor, est_sums: torch.Tensor,
                      x: torch.Tensor):
    """Torch twin of ``rho_from_ratio_svd`` + ``init_state`` in float64 on
    the inputs' device.  Returns (x_weighted, norm_factors, rho_init)."""
    cov = cov_sums.to(torch.float64)
    est = est_sums.to(torch.float64)
    rho = 1 - cov / (est + 1)
    low_di = rho.amax(dim=1) < 0.1
    count_sums = torch.where(low_di.any(),
                             (x * low_di[:, None]).sum(dim=0), x.sum(dim=0))
    norm = count_sums / median_mid(count_sums)
    return x / norm, norm, rho
