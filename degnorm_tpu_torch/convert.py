"""Carries the JAX package's state across to this package.

There are no weights; what crosses is data and outer-loop state, given as
numpy arrays (this package imports nothing of the JAX package):

  * a packed bucket — the padded coverage array with its lengths and gene
    indices, as ``degnorm_tpu.data.buckets.GeneBucket`` holds them;
  * the outer-loop state — the arrays of ``core.degnorm.GlobalState``, which
    are also the arrays of the JAX package's ``degnorm_checkpoint.npz``.

The parity tests use these so that one bucket step and one outer update see
identical inputs on both sides.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from degnorm_tpu_torch.core.degnorm import DeviceState, GlobalState
from degnorm_tpu_torch.data.buckets import GeneBucket
from degnorm_tpu_torch.engine import resolve_device

_STATE_FIELDS = GlobalState._fields


def buckets_from_numpy(F: np.ndarray, lengths: np.ndarray,
                       gene_indices: np.ndarray, width: int,
                       device="cuda",
                       ) -> Tuple[GeneBucket, torch.Tensor, torch.Tensor]:
    """One packed bucket -> (GeneBucket, coverage tensor, length-mask tensor)
    on ``device``.  ``F`` is the padded (G, p, W) array; an int16 array is
    uploaded as it is (the bucket step casts it)."""
    dev = resolve_device(device)
    F = np.ascontiguousarray(F)
    if F.ndim != 3 or F.shape[2] != int(width):
        raise ValueError(f"F must be (G, p, {width}), got {F.shape}")
    bucket = GeneBucket(width=int(width), F=F,
                        lengths=np.asarray(lengths, np.int32),
                        gene_indices=np.asarray(gene_indices, np.int32))
    if bucket.lengths.shape != (F.shape[0],) \
            or bucket.gene_indices.shape != (F.shape[0],):
        raise ValueError("lengths and gene_indices must be (G,)")
    F_dev = torch.from_numpy(F).to(dev)
    mask_dev = torch.from_numpy(bucket.len_mask()).to(dev)
    return bucket, F_dev, mask_dev


def global_state_from_numpy(x, x_weighted, x_adj, rho, norm_factors,
                            scale_factors, device="cuda") -> DeviceState:
    """Outer-loop state as float64 tensors on ``device``."""
    dev = resolve_device(device)
    arrays = (x, x_weighted, x_adj, rho, norm_factors, scale_factors)
    return DeviceState(*(
        torch.from_numpy(np.array(a, dtype=np.float64)).to(dev)
        for a in arrays))


def global_state_from_checkpoint(arrays: Mapping[str, np.ndarray],
                                 device="cuda") -> DeviceState:
    """Same, from the arrays of a ``degnorm_checkpoint.npz`` (any mapping
    with the state's field names; extra keys such as ``iteration``,
    ``genes`` and ``ran_baseline_selection`` are ignored)."""
    return global_state_from_numpy(*(arrays[k] for k in _STATE_FIELDS),
                                   device=device)
