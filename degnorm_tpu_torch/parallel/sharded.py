"""Gene-data-parallel execution over several devices: the counterpart of
``degnorm_tpu/parallel/sharded.py``.

Genes are the data-parallel axis.  A bucket's slots are cut into contiguous
ranges, one a shard (``shard_slots``, the layout ``NamedSharding(P("genes"))``
gives the JAX bucket); a shard's coverage and mask live on its device, and
the whole bucket step runs there with no communication, since baseline
selection is independent from gene to gene.  A shard's kernels launch by
the whole bucket's gene count (``bucket_genes``), so each gene takes the
launch it takes on one device.

What crosses devices: after each step every shard's raw DI rows and
baseline-selection flags are gathered into the whole (n, p) and (n,)
arrays, and the outer update runs on them (on every process of a
multi-process run).  That moves more than the JAX package's psum of (p,)
column sums, but the outer update then sees the operands of the
single-device fit, so a sharded fit is bit-equal to it wherever each
shard's per-gene results are.

Every process packs the same global buckets (the ETL is replicated, as in
the JAX package) and uploads only its own shards.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from degnorm_tpu_torch.config import EngineConfig, NMFConfig


@dataclasses.dataclass(frozen=True)
class GeneMesh:
    """The shards of a gene-sharded fit.  ``devices``: this process's
    shards' devices, one a shard, in shard order (a device may repeat: two
    shards on one card).  Each of ``process_count`` processes holds as many
    shards; process ``i`` holds shards ``i * k`` to ``i * k + k - 1``."""

    devices: Tuple[torch.device, ...]
    process_index: int = 0
    process_count: int = 1

    @property
    def size(self) -> int:
        """Shards over all processes."""
        return len(self.devices) * self.process_count

    @property
    def local_shards(self) -> range:
        k = len(self.devices)
        return range(self.process_index * k, (self.process_index + 1) * k)

    def device_of(self, shard: int) -> torch.device:
        """The device of one of this process's shards."""
        return self.devices[shard - self.process_index * len(self.devices)]


def make_mesh(devices: Optional[Sequence] = None) -> GeneMesh:
    """A one-process gene mesh over ``devices`` (``torch.device`` or names;
    a device may repeat), by default every visible card.  Without a card
    and without ``devices`` it raises: a mesh never moves to the CPU on its
    own (the tests pass ``["cpu"] * k``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "the devices (e.g. ['cpu', 'cpu'])")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = tuple(_indexed(torch.device(d)) for d in devices)
    if not devs:
        raise ValueError("make_mesh: no devices")
    return GeneMesh(devs)


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so equal devices compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def shard_slots(G: int, n_shards: int) -> List[Tuple[int, int]]:
    """Contiguous ``[start, stop)`` slot ranges of a G-slot bucket over
    ``n_shards`` shards, in shard order; the first ``G % n_shards`` shards
    take one slot more (a shard may be empty when G < n_shards)."""
    if n_shards < 1:
        raise ValueError("shard_slots: n_shards must be >= 1")
    q, r = divmod(G, n_shards)
    out, start = [], 0
    for s in range(n_shards):
        stop = start + q + (s < r)
        out.append((start, stop))
        start = stop
    return out


def shard_bucket(F: np.ndarray, len_mask: np.ndarray, mesh: GeneMesh
                 ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """This process's shards of a padded bucket, each ``(F slice, mask
    slice)`` on its shard's device, in shard order; ``F`` keeps its type
    (int16 or float)."""
    slots = shard_slots(F.shape[0], mesh.size)
    return [(torch.from_numpy(F[slots[s][0]:slots[s][1]]).to(mesh.device_of(s)),
             torch.from_numpy(len_mask[slots[s][0]:slots[s][1]])
             .to(mesh.device_of(s)))
            for s in mesh.local_shards]


def sharded_iteration_step(
    shards: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    x_weighted: torch.Tensor,
    scale_factors: torch.Tensor,
    ds_start: torch.Tensor,
    nmf_cfg: NMFConfig,
    eng_cfg: EngineConfig,
    mesh: GeneMesh,
):
    """One complete DegNorm iteration for one gene-sharded bucket of a
    one-process mesh: ``_bucket_step`` on every shard (``shard_bucket``'s
    output), every shard's work queued before the host reads any
    (``run_steps``), then the outer update on the gathered rows, on the
    mesh's first device.  ``x_weighted`` (G, p) and ``ds_start`` (G,) are
    row-aligned with the whole bucket; ``scale_factors`` (p,).

    Returns (rho, x_adj, x_weighted', norm_factors, scale_factors', ran_bs)
    as in the JAX package (reference nmf.py:560-596)."""
    from degnorm_tpu_torch.core import degnorm as outer
    from degnorm_tpu_torch.engine import _bucket_steps, _torch_dtype
    from degnorm_tpu_torch.ops.cuda_trim import run_steps
    if mesh.process_count != 1:
        raise ValueError("sharded_iteration_step: a one-process mesh")
    G = int(x_weighted.shape[0])
    slots = shard_slots(G, mesh.size)
    sf = scale_factors.to(_torch_dtype(eng_cfg.dtype))
    results = run_steps(
        _bucket_steps(F, m, sf.to(F.device), ds_start[a:b].to(F.device),
                      nmf_cfg.kernel_key(), eng_cfg, bucket_genes=G)
        for (F, m), (a, b) in zip(shards, slots) if b > a)
    first = mesh.devices[0]
    rho_raw = torch.cat([r.rho.to(first) for r in results])
    ran_bs = torch.cat([r.ran_bs.to(first) for r in results])
    rho, x_adj, xw, norm, scale = outer.device_iteration_math(
        rho_raw, x_weighted.to(first), scale_factors.to(first))
    return rho, x_adj, xw, norm, scale, ran_bs
