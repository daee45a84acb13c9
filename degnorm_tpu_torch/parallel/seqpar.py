"""Column-sharded (sequence-parallel) buckets for outlier-length genes: the
counterpart of ``degnorm_tpu/parallel/seqpar.py``.

On a mesh of two or more shards the engine cuts a bucket at least
``EngineConfig.seqpar_width`` wide along its COLUMNS (positions) instead of
its genes (``engine.py::_upload``): such a bucket holds the few longest
genes of an annotation (TTN alone is over 100,000 bases), and gene-sharding
would put each of them whole on one card while the others wait.  Shard ``s``
holds columns ``[s * width, (s + 1) * width)`` of every gene, masked off
past the bucket's width (``column_slots``).

Every per-gene reduction over the columns is then a partial on each shard
followed by one reduction across the shards, at the points where the JAX
package's GSPMD lowering places its all-reduces: the p x p Gram of each
power step, row sums, column maxima, per-bin sums, and the ranks of the
high-coverage columns (an exclusive scan of the shards' counts, so that a
trim bin may straddle a shard boundary).  A shard's step code asks for a
reduction through its ``Columns`` object (``sum_``, ``max_``,
``exclusive_scan``: step generators, ``yield from cols.sum_(t)``);
``ops/cuda_trim.py::run_steps``, which runs the step generators, collects
the asks of every local shard of the bucket and answers them with
``ColumnGroup.combine``.  On one
device, ``ONE_DEVICE`` answers at once with the value itself, so the one-
device code path and its bits do not change.

``combine`` reduces in global shard order on the first local shard's device
and copies the result to every shard; on a multi-process mesh the shards'
partials are first gathered from every process (``distributed.gather_equal``,
one all-gather) and each process reduces them in the same order.  One more
ask, ``gather_``, hands the partials back UNSUMMED, in global shard order:
kernels 4c and 2c sum them inside their next launch.  A shard writes its
partial straight into its slot of a buffer the group owns (``partials``:
one a device, two parities); where the shards share a device the answer is
that buffer itself and the host does no tensor work, across devices each
buffer gets the other devices' slots by peer copies, and across processes
the answer is the one all-gather's output.  Every
shard of every process so ends with the same bits, which the step needs: the
power steps, ``active`` and every bail-out are decided on reduced values,
and a shard that decided otherwise would leave the trim loop while another
waits in a collective.  (An all-reduce could give processes other bits
where the backend picks another order; the partials are a few p x p
matrices a gene, so gathering them costs no more.)
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from degnorm_tpu_torch.parallel import distributed
from degnorm_tpu_torch.parallel.sharded import GeneMesh

# Columns are cut in chunks of this many (csrc/stream.cuh's DN_STREAM_CHUNK).
CHUNK = 128


def column_slots(W: int, n_shards: int) -> Tuple[List[Tuple[int, int]], int]:
    """Contiguous ``[start, stop)`` column ranges of a W-wide bucket over
    ``n_shards`` shards, in shard order, and the width every shard is padded
    to: a multiple of ``CHUNK``, ``ceil(W / (n_shards * CHUNK)) * CHUNK``.
    Shard ``s`` starts at ``s * width``; the padding past W is last (the
    last shard's tail, or whole shards where W is small)."""
    if n_shards < 1:
        raise ValueError("column_slots: n_shards must be >= 1")
    width = -(-W // (n_shards * CHUNK)) * CHUNK
    return ([(min(s * width, W), min((s + 1) * width, W))
             for s in range(n_shards)], width)


def shard_columns(F: np.ndarray, len_mask: np.ndarray, mesh: GeneMesh
                  ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """This process's column shards of a padded (G, p, W) bucket, each
    ``(F columns, mask columns)`` padded to the shards' common width (zeros,
    masked off) and on its shard's device, in shard order; ``F`` keeps its
    type (int16 or float)."""
    slots, width = column_slots(F.shape[2], mesh.size)
    out = []
    for s in mesh.local_shards:
        a, b = slots[s]
        Fs = np.zeros(F.shape[:2] + (width,), F.dtype)
        ms = np.zeros((F.shape[0], width), bool)
        Fs[:, :, :b - a] = F[:, :, a:b]
        ms[:, :b - a] = len_mask[:, a:b]
        dev = mesh.device_of(s)
        out.append((torch.from_numpy(Fs).to(dev), torch.from_numpy(ms).to(dev)))
    return out


class Reduction(NamedTuple):
    """What a shard's step generator yields to ask for a reduction across
    its bucket's shards (answered by ``group.combine``)."""
    group: "ColumnGroup"
    op: str                 # "sum", "max", "scan" (exclusive), "gather"
    value: torch.Tensor


class Columns:
    """One shard's columns of a bucket: its global column offset, and the
    reductions across the bucket's shards as step generators
    (``x = yield from cols.sum_(partial)``).  Without a group (one device,
    ``ONE_DEVICE``) each returns its argument (a scan: zeros) at once."""

    def __init__(self, group: Optional["ColumnGroup"] = None,
                 offset: int = 0, shard: int = 0):
        self.group = group
        self.offset = offset
        self.shard = shard

    @property
    def sharded(self) -> bool:
        return self.group is not None

    @property
    def count(self) -> int:
        """Shards of the bucket, over all processes."""
        return 1 if self.group is None else self.group.mesh.size

    @property
    def genes(self) -> int:
        """The bucket's genes (its slots that hold one), which the launch
        geometry of kernels 4c and 2c reads: the group's."""
        if self.group is None:
            raise ValueError("a bucket on one device has no column group")
        return self.group.genes

    def partials(self, shape: Sequence[int],
                 device: torch.device) -> torch.Tensor:
        """The ``(2, count, *shape)`` float32 buffer on ``device`` whose row
        ``[q, shard]`` takes this shard's partial of parity ``q`` (a sweep's
        parity: a later launch of one shard never overwrites a slot that
        another's launch of the same sweep has yet to read).  The group's,
        made once; without a group a new one."""
        if self.group is None:
            return torch.empty((2, 1) + tuple(shape), dtype=torch.float32,
                               device=device)
        return self.group.partials(shape, device)

    def gather_(self, buf: torch.Tensor):
        """Every shard's partial, unsummed, as a ``(count, ...)`` tensor on
        this shard's device in global shard order.  ``buf`` is one parity
        of ``partials(...)``, its row ``shard`` written by this shard."""
        return (yield from self._ask("gather", buf))

    def sum_(self, t: torch.Tensor):
        return (yield from self._ask("sum", t))

    def max_(self, t: torch.Tensor):
        return (yield from self._ask("max", t))

    def exclusive_scan(self, t: torch.Tensor):
        """The sum of ``t`` over the shards before this one (zeros on the
        first)."""
        return (yield from self._ask("scan", t))

    def _ask(self, op: str, t: torch.Tensor):
        if self.group is None:
            return torch.zeros_like(t) if op == "scan" else t
        return (yield Reduction(self.group, op, t))


ONE_DEVICE = Columns()


class ColumnGroup:
    """The column shards of one bucket over a mesh: ``mesh.size`` shards of
    ``width`` columns each (``column_slots``), this process holding
    ``mesh.local_shards``; ``genes`` of its slots hold a gene.  Counts its
    reductions (sums, maxima, scans) and their host seconds, and apart from
    them its gather asks and theirs."""

    def __init__(self, mesh: GeneMesh, W: int, genes: int):
        self.mesh = mesh
        self.W = W
        self.genes = genes
        self.width = column_slots(W, mesh.size)[1]
        self.reductions = 0
        self.seconds = 0.0
        self.gathers = 0
        self.gather_seconds = 0.0
        self._partials = {}

    def columns(self) -> List[Columns]:
        """The ``Columns`` of this process's shards, in shard order."""
        return [Columns(self, s * self.width, s)
                for s in self.mesh.local_shards]

    def partials(self, shape: Sequence[int],
                 device: torch.device) -> torch.Tensor:
        """The group's ``(2, mesh.size, *shape)`` float32 buffer on
        ``device`` (``Columns.partials``), made at the first ask."""
        key = (tuple(shape), torch.device(device))
        if key not in self._partials:
            self._partials[key] = torch.empty(
                (2, self.mesh.size) + tuple(shape), dtype=torch.float32,
                device=device)
        return self._partials[key]

    def combine(self, asks: Sequence[Reduction]) -> List[torch.Tensor]:
        """Answer one reduction of every local shard (``asks`` in shard
        order): the partials reduced in global shard order, the same bits
        on every shard, each on its shard's device; a ``gather`` ask gets
        them unsummed (``_gather``)."""
        t0 = time.perf_counter()
        ops = {a.op for a in asks}
        if len(asks) != len(self.mesh.devices) or len(ops) != 1:
            raise RuntimeError(
                f"column shards diverged: {len(asks)} of "
                f"{len(self.mesh.devices)} local shards asked for {ops}")
        op = ops.pop()
        if op == "gather":
            res = self._gather([a.value for a in asks])
            self.gathers += 1
            self.gather_seconds += time.perf_counter() - t0
            return res
        home = asks[0].value.device
        parts = torch.stack([a.value.to(home) for a in asks])
        if self.mesh.process_count > 1:
            parts = distributed.gather_equal(parts).flatten(0, 1)
        if op == "max":
            red = parts.amax(dim=0)
            out = [red] * len(asks)
        elif op == "sum":
            red = parts[0].clone()
            for t in parts[1:]:
                red += t
            out = [red] * len(asks)
        elif op == "scan":
            first = self.mesh.local_shards.start
            acc = torch.zeros_like(parts[0])
            out = []
            for s in range(first + len(asks)):
                if s >= first:
                    out.append(acc.clone())
                acc += parts[s]
        else:
            raise ValueError(f"unknown reduction {op!r}")
        res = [t if a.value.device == home else t.to(a.value.device)
               for t, a in zip(out, asks)]
        # each shard gets a tensor of its own
        res = [t if i == 0 else t.clone() for i, t in enumerate(res)]
        self.reductions += 1
        self.seconds += time.perf_counter() - t0
        return res

    def _gather(self, bufs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Answer a ``gather_`` ask: ``bufs`` one parity of each local
        shard's ``partials`` buffer, row ``shard`` written by that shard.
        Across processes: the local rows, one all-gather, its output for
        every local shard.  In one process: each buffer gets the other
        buffers' rows of their shards (no copy where the shards share a
        buffer: one device) and is its shard's answer."""
        shards = self.mesh.local_shards
        if self.mesh.process_count > 1:
            home = bufs[0].device
            local = torch.stack([b[s].to(home) for b, s in zip(bufs, shards)])
            full = distributed.gather_equal(local).flatten(0, 1)
            return [full if b.device == home else full.to(b.device)
                    for b in bufs]
        for b in bufs:
            for o, s in zip(bufs, shards):
                if o.data_ptr() != b.data_ptr():
                    b[s].copy_(o[s])
        return list(bufs)

    def cat_columns(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The (G, W) tensor of a per-column quantity from this process's
        shards' (G, width) parts (shard order), on the first local shard's
        device; on a multi-process mesh every process's parts are gathered
        first (a collective: every process calls it)."""
        home = parts[0].device
        stack = torch.stack([t.to(home) for t in parts])
        if self.mesh.process_count > 1:
            stack = distributed.gather_equal(stack).flatten(0, 1)
        return torch.cat(list(stack), dim=1)[:, :self.W]
