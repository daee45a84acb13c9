"""Batched masked NMF-over-approximation inner loop.

Counterpart of ``degnorm_tpu/core/nmf.py``: the clipped-Lagrangian fixed
point of reference ``GeneNMFOA.nmf`` (``degnorm/nmf.py:78-107``) for a whole
(G, p, W) gene bucket.  With ``use_kernels`` the work goes to the CUDA kernel
wrappers of ``ops/cuda_nmf.py`` and ``ops/cuda_stream.py`` (which run their
plain versions on CPU tensors); otherwise to the plain versions directly.

The final over-approximation clip is intentionally NOT applied here: the
reference clips selectively at call sites.

On a column shard of a bucket (``parallel/seqpar.py``) the ``*_steps``
forms take the column-sharded route: kernels 4c and 2c
(``cuda_stream.nmf_masked_colsharded_cuda``,
``cuda_nmf.ratio_rowsums_colsharded_cuda``), which return partials that are
reduced across the shards between their launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from degnorm_tpu_torch.config import nmf_tol_applies
from degnorm_tpu_torch.ops import cuda_nmf, cuda_stream
from degnorm_tpu_torch.parallel.seqpar import ONE_DEVICE, Columns


def nmf_masked(
    F: torch.Tensor,
    mask: torch.Tensor,
    *,
    nmf_iter: int,
    power_iters_cold: int = 30,
    power_iters_warm: int = 6,
    power_warm_plain: int = 0,
    gene_active: Optional[torch.Tensor] = None,
    u0: Optional[torch.Tensor] = None,
    use_kernels: bool = True,
    F_raw: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
    nmf_tol: float = 0.0,
    method: str = "power",
    bucket_genes: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the NMF-OA loop on a masked gene bucket.

    A bucket inside the resident kernels' gate
    (``cuda_nmf.kernels_supported``) goes to the resident NMF kernel; one
    outside it goes to the streamed kernel, which reads the raw coverage
    when an int16 ``F_raw`` and ``scale`` are both given.  ``use_kernels=False``
    takes the plain versions by the same routing (by shape: a float64 bucket
    of the CPU tests routes as its float32 form would).

    Args:
      F: (G, p, W) nonnegative coverage batch (already scale-adjusted).
      mask: (G, W) active-column mask.
      nmf_iter: number of Lagrangian iterations (reference ``nmf_iter``).
      power_warm_plain: 0 = squared warm power scheme at
        ``power_iters_warm``; > 0 = that many plain warm matvecs.
      gene_active: optional (G,) bool; genes outside it are skipped and
        return zeros — callers gate every consumer on their own masks.
      u0: optional (G, p) warm start for the initial cold rank-1.
      F_raw/scale: the engine's raw device-resident coverage and the
        per-sample scale vector with F == F_raw / scale; where F_raw is
        int16 the streamed kernel reads it at half the bytes and adjusts
        each column itself, bit-identically (ops/cuda_stream.py).  A raw
        tensor of another type saves no bytes: F is used.
      nmf_tol: the adaptive freeze (``EngineConfig.nmf_tol``), where
        ``config.nmf_tol_applies`` holds for the bucket and the resident
        route runs it; the streamed kernel ignores it, as the JAX package's
        does.
      method: "power", or "eigh": every fit by a batched eigendecomposition
        through the plain version at any width, with ``nmf_tol`` at every
        width (the JAX package's XLA twin); no kernel is launched.
      bucket_genes: the whole bucket's gene count where F is one shard of
        it: the resident kernel's launch rule reads it
        (``cuda_nmf.nmf_masked_cuda``).

    Returns (K, E, u): rank-1 factors (G,p), (G,W) and the final unit left
    vector for warm starts.
    """
    kwargs = dict(nmf_iter=nmf_iter, power_iters_cold=power_iters_cold,
                  power_iters_warm=power_iters_warm,
                  power_warm_plain=power_warm_plain,
                  gene_active=gene_active, u0=u0)
    if method == "eigh":
        return cuda_nmf.nmf_masked_plain(F, mask, nmf_tol=nmf_tol,
                                         method=method, **kwargs)
    if cuda_nmf.kernels_supported(F.shape, torch.float32):
        tol = nmf_tol if nmf_tol_applies(F.shape) else 0.0
        if use_kernels:
            return cuda_nmf.nmf_masked_cuda(F, mask, nmf_tol=tol,
                                            bucket_genes=bucket_genes,
                                            **kwargs)
        return cuda_nmf.nmf_masked_plain(F, mask, nmf_tol=tol, **kwargs)
    fn = (cuda_stream.nmf_masked_streamed_cuda if use_kernels
          else cuda_stream.nmf_masked_streamed_plain)
    use_raw = (F_raw is not None and scale is not None
               and F_raw.dtype == torch.int16)
    return fn(F_raw if use_raw else F, mask,
              scale=scale if use_raw else None, **kwargs)


def nmf_masked_steps(F: torch.Tensor, mask: torch.Tensor, *,
                     cols: Columns = ONE_DEVICE, **kwargs):
    """``nmf_masked`` as a step generator.  On a column shard (``cols``) the
    column-sharded route, whatever the bucket's shape, as the JAX package
    takes its XLA path for such a bucket: kernel 4c on the raw int16
    coverage where there is one (``cuda_stream.nmf_masked_colsharded_cuda``,
    the plain version on the CPU and with ``use_kernels=False``), or the
    plain version under ``method="eigh"``, which no kernel has.
    ``nmf_tol`` applies there at any width, as on the JAX package's XLA
    path.  ``bucket_genes`` is not read: kernel 4c picks its blocks a gene
    from the column group (``cuda_stream.pick_cols_geometry``).
    Returns (K, E, u), E over the shard's columns."""
    if not cols.sharded:
        return nmf_masked(F, mask, **kwargs)
    use_kernels = kwargs.pop("use_kernels", True)
    F_raw, scale = kwargs.pop("F_raw", None), kwargs.pop("scale", None)
    kwargs.pop("bucket_genes", None)
    plain = kwargs.get("method", "power") == "eigh" or not use_kernels
    fn = (cuda_stream.nmf_masked_colsharded_plain if plain
          else cuda_stream.nmf_masked_colsharded_cuda)
    use_raw = (F_raw is not None and scale is not None
               and F_raw.dtype == torch.int16)
    return (yield from fn(F_raw if use_raw else F, mask, cols,
                          scale=scale if use_raw else None, **kwargs))


def ratio_svd_rowsums_steps(F: torch.Tensor, mask: torch.Tensor, *,
                            cols: Columns = ONE_DEVICE, **kwargs):
    """``ratio_svd_rowsums`` as a step generator: on a column shard, kernel
    2c (``cuda_nmf.ratio_rowsums_colsharded_cuda``; its plain version under
    ``method="eigh"`` or ``use_kernels=False``).  Returns (cov_sums,
    est_sums), whole on every shard."""
    if not cols.sharded:
        return ratio_svd_rowsums(F, mask, **kwargs)
    kwargs.pop("bucket_genes", None)
    use_kernels = kwargs.pop("use_kernels", True)
    plain = kwargs.get("method", "power") == "eigh" or not use_kernels
    fn = (cuda_nmf.ratio_rowsums_colsharded_plain if plain
          else cuda_nmf.ratio_rowsums_colsharded_cuda)
    return (yield from fn(F, mask, cols, **kwargs))


def ratio_svd_rowsums(
    F: torch.Tensor,
    mask: torch.Tensor,
    *,
    power_iters: int = 30,
    use_kernels: bool = True,
    method: str = "power",
    bucket_genes: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row sums of the one-shot clipped rank-1 over-approximation
    (reference ``ratio_svd``, nmf.py:109-121): per-sample sums of F and of
    max(K·E, F), both over active columns.  Returns (cov_sums, est_sums).
    The kernel takes every width, so a wide bucket's initialisation runs in
    it too (the JAX package leaves that one to XLA), and int16 coverage as
    it is: both paths compute on its exact float32 values.
    ``method="eigh"`` takes the plain version (the JAX package's XLA path
    for that method).  ``bucket_genes``: as in ``nmf_masked``, for the
    kernel's launch rule."""
    if method == "eigh":
        return cuda_nmf.ratio_rowsums_plain(F, mask, power_iters=power_iters,
                                            method=method)
    if use_kernels:
        return cuda_nmf.ratio_rowsums_cuda(F, mask, power_iters=power_iters,
                                           bucket_genes=bucket_genes)
    return cuda_nmf.ratio_rowsums_plain(F, mask, power_iters=power_iters)
