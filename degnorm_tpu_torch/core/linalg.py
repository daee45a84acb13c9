"""Batched, masked rank-1 factorization on torch tensors.

Counterpart of ``degnorm_tpu/core/linalg.py``.  ``p`` (samples) is tiny and
``W`` (positions) is large, so the dominant left singular vector of the
masked (p, W) matrix A is the dominant eigenvector of the p x p Gram matrix
B = A Aᵀ.  A is nonnegative, so that eigenvector is the Perron vector and a
power iteration from a strictly positive start converges without deflation.
Zeroing masked columns is exact for the rank-1 factors.

These are the plain building blocks; the CUDA kernels in ``ops/`` implement
the same arithmetic per gene.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

_EPS = 1e-30


def _gram(A: torch.Tensor) -> torch.Tensor:
    """Batched B = A Aᵀ over the wide axis: (G,p,W) -> (G,p,p)."""
    return torch.einsum("gpw,gqw->gpq", A, A)


def _normalized(B: torch.Tensor) -> torch.Tensor:
    """B scaled by its largest absolute entry (spectral radius in [1, p]).
    Divides, as the JAX package does; the CUDA kernels multiply by one
    reciprocal of ``bmax + eps`` instead (csrc/common.cuh::normalize_rows),
    a last-bit difference of a scale that the power steps normalise away,
    inside the kernels' tolerance."""
    bmax = B.abs().amax(dim=(1, 2), keepdim=True)
    return B / (bmax + _EPS)


def _renormalize(w: torch.Tensor, u_prev: torch.Tensor) -> torch.Tensor:
    """w / |w|, keeping the previous iterate when the update collapsed
    (all-zero Gram), so a zero gene degrades to s=0 instead of NaN."""
    nrm = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    return torch.where(nrm > _EPS, w / (nrm + _EPS), u_prev)


def _power_iterate(B: torch.Tensor, u0: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Squared-operator power iteration: normalize the Gram, square it once,
    and apply B² twice per body without intermediate normalization.  Runs
    ``max(1, n_iters // 4)`` bodies, i.e. effectively 4 plain steps each."""
    Bn = _normalized(B)
    B2 = torch.einsum("gik,gkj->gij", Bn, Bn)
    u = u0
    for _ in range(max(1, n_iters // 4)):
        v = torch.einsum("gpq,gq->gp", B2, u)
        w = torch.einsum("gpq,gq->gp", B2, v)
        u = _renormalize(w, u)
    return u


def _power_warm_plain(B: torch.Tensor, u0: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Warm-restart scheme of the fused kernels: ``n_iters`` plain matvecs on
    the max-normalized Gram with a single final normalization."""
    Bn = _normalized(B)
    w = u0
    for _ in range(n_iters):
        w = torch.einsum("gpq,gq->gp", Bn, w)
    return _renormalize(w, u0)


def _default_u0(F: torch.Tensor) -> torch.Tensor:
    p = F.shape[1]
    return torch.full(F.shape[:2], 1.0 / (p ** 0.5), dtype=F.dtype,
                      device=F.device)


def _eigh_dominant(B: torch.Tensor) -> torch.Tensor:
    """Dominant eigenvector of each Gram by a batched ``eigh`` (eigenvalues
    ascending: the last column), its sign turned toward a non-negative sum
    (``degnorm_tpu/core/linalg.py::_eigh_dominant``)."""
    _, vecs = torch.linalg.eigh(B)
    u = vecs[..., -1]
    return u * torch.where(u.sum(dim=-1, keepdim=True) < 0, -1.0, 1.0)


def _dominant(B: torch.Tensor, u0: Optional[torch.Tensor], like: torch.Tensor,
              n_iters: int, warm_plain: int, method: str) -> torch.Tensor:
    """The left vector of a rank-1 fit from its Gram: ``eigh``, or power
    iteration from ``u0`` (squared scheme, or ``warm_plain`` plain matvecs,
    which needs ``u0``).  ``eigh`` ignores ``u0`` and the counts."""
    if method == "eigh":
        return _eigh_dominant(B)
    if u0 is None:
        u0 = _default_u0(like)
    return (_power_warm_plain(B, u0, warm_plain) if warm_plain
            else _power_iterate(B, u0, n_iters))


def masked_rank_one_uv(
    F: torch.Tensor,
    mask: torch.Tensor,
    *,
    n_iters: int = 30,
    u0: Optional[torch.Tensor] = None,
    warm_plain: int = 0,
    method: str = "power",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale-free rank-1 state (u, v_raw = Aᵀu), no sigma.  ``warm_plain > 0``
    replaces the squared scheme by that many plain matvecs (needs ``u0``);
    ``method="eigh"`` takes u from a batched eigendecomposition instead."""
    A = F * mask.to(F.dtype)[:, None, :]
    u = _dominant(_gram(A), u0, F, n_iters, warm_plain, method)
    v = torch.einsum("gpw,gp->gw", A, u)
    return u, v


def _scale_of(B: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """s = sqrt(max(uᵀBu, 0)), the singular value of a unit left vector."""
    Bu = torch.einsum("gpq,gq->gp", B, u)
    return torch.sqrt(torch.clamp_min(torch.einsum("gp,gp->g", u, Bu), 0.0))


def finish_rank_one(
    X: torch.Tensor,
    mask: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialize (K, E) from a ``masked_rank_one_uv`` state: s from the
    Rayleigh quotient of X's Gram, K = u·s, E = v/s."""
    A = X * mask.to(X.dtype)[:, None, :]
    s = _scale_of(_gram(A), u)
    return u * s[:, None], v / (s[:, None] + _EPS)


def masked_rank_one(
    F: torch.Tensor,
    mask: torch.Tensor,
    *,
    n_iters: int = 30,
    u0: Optional[torch.Tensor] = None,
    warm_plain: int = 0,
    method: str = "power",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank-1 factorization K·E of each masked gene matrix, from one Gram.

    Returns K (G,p) = u·s, E (G,W) = Aᵀu / s (zero on masked columns) and the
    unit left vector u (G,p) for warm starts.
    """
    A = F * mask.to(F.dtype)[:, None, :]
    B = _gram(A)
    u = _dominant(B, u0, F, n_iters, warm_plain, method)
    s = _scale_of(B, u)
    v = torch.einsum("gpw,gp->gw", A, u)
    return u * s[:, None], v / (s[:, None] + _EPS), u


def outer_product(K: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
    """(G,p) x (G,W) -> (G,p,W) rank-1 reconstruction K·E."""
    return K[:, :, None] * E[:, None, :]


def masked_rowsum(X: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(G,p,W) row sums over active columns -> (G,p)."""
    return torch.einsum("gpw,gw->gp", X, mask.to(X.dtype))


def median_mid(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Median that averages the two middle values for an even count (numpy's
    rule; ``torch.median`` returns the lower one)."""
    s, _ = torch.sort(x, dim=dim)
    n = x.shape[dim]
    lo = s.select(dim, (n - 1) // 2)
    hi = s.select(dim, n // 2)
    return (lo + hi) / 2
