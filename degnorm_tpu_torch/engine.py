"""DegNormEngine — the PyTorch/CUDA equivalent of reference ``GeneNMFOA``.

Counterpart of ``degnorm_tpu/engine.py``: on one device, or gene-sharded
over a ``parallel.GeneMesh`` of devices and processes.  Public API mirrors
``GeneNMFOA.run(cov_dat, reads_dat)`` (nmf.py:483-601): an ordered
{gene: (p x L_i) coverage matrix} mapping plus an (n x p) read count matrix
in, DI scores / adjusted counts / coverage estimates out.

Execution model:
  * genes are packed into padded length buckets (data/buckets.py) and
    uploaded once (int16 where the coverage is integral);
  * per DegNorm iteration, each bucket runs ``_bucket_step`` (scale-adjust,
    then core/baseline.py: the NMF kernel, the trim loop, the envelope
    refit), bucket arrays staying resident across iterations.  A bucket
    inside the resident kernels' gate takes the resident NMF kernel and the
    fused trim kernel; a wider one takes the streamed NMF kernel, on the raw
    int16 coverage where there is one, once per round of the unfused loop;
  * the cross-gene reductions (medians, column sums) run on the device in
    float64 (core/degnorm.py);
  * on a mesh every bucket is cut into one shard a mesh device
    (parallel/sharded.py): each runs the bucket step on its device, and the
    per-gene rows are gathered before the outer update, which runs on the
    mesh's first device of every process;
  * on a mesh of two or more shards a bucket at least
    ``EngineConfig.seqpar_width`` wide is cut along its columns instead
    (parallel/seqpar.py): every shard holds all its genes, each reduction
    over the columns is reduced across the shards inside the step, and the
    per-gene rows come out whole on every shard, so the outer update takes
    the first shard's with no gather.
"""
from __future__ import annotations

import time
import contextlib
import os
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch

from degnorm_tpu_torch.config import EngineConfig, NMFConfig
from degnorm_tpu_torch.core import degnorm as outer
from degnorm_tpu_torch.core import prng
from degnorm_tpu_torch.core.baseline import (BucketResult,
                                             baseline_select_steps,
                                             materialize_estimate)
from degnorm_tpu_torch.core.nmf import ratio_svd_rowsums_steps
from degnorm_tpu_torch.data.buckets import (GeneBucket, bucket_width,
                                            integral_int16able, pack_buckets)
from degnorm_tpu_torch.data.encode import int16able
from degnorm_tpu_torch.ops import cuda_nmf
from degnorm_tpu_torch.ops.cuda_trim import run_steps
from degnorm_tpu_torch.parallel import distributed
from degnorm_tpu_torch.parallel.seqpar import (ONE_DEVICE, ColumnGroup,
                                               Columns, shard_columns)
from degnorm_tpu_torch.parallel.sharded import (GeneMesh, make_mesh,
                                                shard_bucket, shard_slots)
from degnorm_tpu_torch.pipeline.checkpoints import (load_checkpoint,
                                                    save_checkpoint)


def resolve_device(device) -> torch.device:
    """The engine's device; raises when a GPU is asked for and none is
    present (the engine never moves to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "degnorm_tpu_torch runs on a CUDA device and none is available; "
            "set EngineConfig(device='cpu') to run the plain versions on the "
            "CPU")
    return dev


def _device_memory(dev: torch.device) -> int:
    """Bytes of memory the packer's guard reckons with: the card's total, or
    16 GiB for the CPU."""
    if dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[1])
    return 16 << 30


def _torch_dtype(name: str) -> torch.dtype:
    return torch.float64 if name == "float64" else torch.float32


def _data_fingerprint(cov_mats, n) -> tuple:
    """Content-derived dataset fingerprint for the reuse_device_data guard:
    shapes plus edge-column sums of the first/last matrices (cheap, and not
    fooled by recycled object ids)."""
    if not cov_mats:
        return (n, 0)
    f0, f1 = cov_mats[0], cov_mats[-1]
    total_w = sum(int(F.shape[1]) for F in cov_mats)
    return (n, len(cov_mats), total_w, f0.shape, f1.shape,
            float(np.asarray(f0[:, 0]).sum()),
            float(np.asarray(f0[:, -1]).sum()),
            float(np.asarray(f1[:, 0]).sum()),
            float(np.asarray(f1[:, -1]).sum()))


def _f64(t: torch.Tensor) -> np.ndarray:
    """A device tensor as a host float64 array."""
    return t.detach().cpu().numpy().astype(np.float64)


def _bucket_step(*args, **kwargs) -> BucketResult:
    """``_bucket_steps`` run to its end, with its arguments."""
    return run_steps([_bucket_steps(*args, **kwargs)])[0]


def _bucket_steps(F: torch.Tensor, len_mask: torch.Tensor,
                  scale_factors: torch.Tensor,
                  ds_start: Optional[torch.Tensor],
                  nmf_cfg: NMFConfig, eng_cfg: EngineConfig,
                  with_estimates: bool = True,
                  bucket_genes: Optional[int] = None,
                  cols: Columns = ONE_DEVICE):
    """One DegNorm iteration's device work for one bucket (or one shard of
    it: ``bucket_genes`` is then the whole bucket's gene count; ``cols`` a
    column shard's ``Columns``, see ``baseline_select_steps``), as a step
    generator (``ops/cuda_trim.py::run_steps``): scale-adjust the coverage
    (nmf.py:142-146,563) then run batched baseline selection.
    ``F`` may arrive as int16 (integral coverage uploads at half the bytes):
    it is cast to the compute dtype first, then divided, in that order.  The
    int16 original is also handed down as ``F_raw`` with the scale vector, so
    that the streamed NMF kernel of a wide bucket reads it directly."""
    F_raw = F if F.dtype == torch.int16 else None
    F_adj = F.to(scale_factors.dtype) / scale_factors[None, :, None]
    return (yield from baseline_select_steps(
        F_adj, len_mask, nmf_cfg, eng_cfg, ds_start=ds_start,
        with_estimates=with_estimates, F_raw=F_raw,
        scale=scale_factors if F_raw is not None else None,
        bucket_genes=bucket_genes, cols=cols))


def _bucket_init(*args, **kwargs):
    """``_bucket_init_steps`` run to its end, with its arguments."""
    return run_steps([_bucket_init_steps(*args, **kwargs)])[0]


def _bucket_init_steps(F: torch.Tensor, len_mask: torch.Tensor,
                       eng_cfg: EngineConfig,
                       bucket_genes: Optional[int] = None,
                       cols: Columns = ONE_DEVICE):
    """Initialization as a step generator: ratio-SVD row sums on the raw
    coverage (nmf.py:522-526), at any bucket width.  A float32 engine hands
    the int16 upload over as it is (kernel 2 reads it at half the bytes, and
    both it and the plain version compute on its exact float32 values); any
    other upload is cast to the compute dtype first.  ``bucket_genes``,
    ``cols``: as in ``_bucket_steps``."""
    dtype = _torch_dtype(eng_cfg.dtype)
    uncast = F.dtype == torch.int16 and dtype == torch.float32
    Ff = F if uncast else F.to(dtype)
    return (yield from ratio_svd_rowsums_steps(
        Ff, len_mask, power_iters=eng_cfg.power_iters_cold,
        use_kernels=eng_cfg.use_kernels, method=eng_cfg.rank1_method,
        bucket_genes=bucket_genes, cols=cols))


def _device_scatter(parts: Sequence[torch.Tensor],
                    idx_parts: Sequence[torch.Tensor], n: int, fill):
    """Scatter per-bucket per-gene rows into a global (n, ...) tensor on the
    device (padding slots land in a dropped n-th row)."""
    shape = (n + 1,) + tuple(parts[0].shape[1:])
    out = torch.full(shape, fill, dtype=parts[0].dtype, device=parts[0].device)
    for part, idx in zip(parts, idx_parts):
        safe = torch.where(idx >= 0, idx, torch.full_like(idx, n))
        out[safe] = part
    return out[:n]


class DegNormResult:
    """Fit outputs; attribute names follow the reference's GeneNMFOA state."""

    def __init__(self, genes, rho, x_adj, scale_factors, norm_factors,
                 ran_baseline_selection, x_weighted, engine):
        self.genes = genes
        self.rho = rho
        self.x_adj = x_adj
        self.scale_factors = scale_factors
        self.norm_factors = norm_factors
        self.ran_baseline_selection = ran_baseline_selection
        self.x_weighted = x_weighted
        self._engine = engine

    def estimates(self) -> List[np.ndarray]:
        """Materialize per-gene estimated coverage matrices (p x L_i), in
        input gene order — the reference's ``run()`` return value."""
        return self._engine._materialize_estimates()


class _Shard(NamedTuple):
    """One of this process's shards: slots [start, stop) of a bucket, or,
    for a column shard (``cols``), every slot and one range of columns."""
    bucket: int
    start: int
    stop: int
    device: torch.device
    cols: Columns = ONE_DEVICE


class DegNormEngine:
    def __init__(self, nmf_cfg: Optional[NMFConfig] = None,
                 eng_cfg: Optional[EngineConfig] = None,
                 mesh: Optional[GeneMesh] = None):
        """Runs on ``eng_cfg.device`` (default "cuda"); a CUDA device that
        is absent raises here.  ``mesh``: shard every bucket's genes over
        the mesh's devices and processes instead, and on a mesh of two or
        more shards the columns of every bucket at least
        ``eng_cfg.seqpar_width`` wide (parallel/; then ``eng_cfg.device`` is
        not read, and the outer update runs on the mesh's first device of
        this process)."""
        self.nmf_cfg = nmf_cfg or NMFConfig()
        self.eng_cfg = eng_cfg or EngineConfig()
        if mesh is None:
            mesh = make_mesh([resolve_device(self.eng_cfg.device)])
        for dev in mesh.devices:
            resolve_device(dev)
        self.mesh = mesh
        self.device = mesh.devices[0]
        self.timings: Dict[str, float] = {}
        # trim rounds of the last fit: per DegNorm iteration, per bucket, the
        # rounds its longest-running gene took (what the unfused loop ran),
        # over this process's shards
        self.trim_rounds: List[List[int]] = []
        self._buckets: List[GeneBucket] = []
        # per shard of this process (one a bucket on one device): coverage,
        # mask, gene ids on self.device, and its last results
        self._shards: List[_Shard] = []
        self._device_F: List[torch.Tensor] = []
        self._device_mask: List[torch.Tensor] = []
        self._device_idx: List[torch.Tensor] = []
        self._global_idx: Optional[torch.Tensor] = None
        self._last_results: List[BucketResult] = []
        self._genes: Optional[List[str]] = None
        self._est_rows = None
        self._final_scale: Optional[np.ndarray] = None
        self._packed_fp = None
        self._ds_ref_draws = None
        self._ds_cache = None
        self._ds_zero_cache: Dict[int, torch.Tensor] = {}
        # per bucket: its ColumnGroup where it is column-sharded, else None
        self._col_groups: List[Optional[ColumnGroup]] = []
        # reductions across column shards in the last fit, and apart from
        # them the gather asks of kernels 4c and 2c
        self.reductions = 0
        self.gathers = 0
        # buckets the JAX engine would column-shard that have more samples
        # than kernels 4c and 2c take, gene-sharded instead
        # (``column_sharded``), counted at the last upload
        self.colshard_declined = 0

    def _sync(self):
        for dev in set(self.mesh.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # -- setup -----------------------------------------------------------
    def _pack(self, cov_mats: Sequence[np.ndarray]):
        self._pack_host(cov_mats)
        self._upload()

    def _pack_host(self, cov_mats: Sequence[np.ndarray]):
        """Scan and pack ``cov_mats`` into ``self._buckets`` on the host."""
        dtype = _torch_dtype(self.eng_cfg.dtype)
        itemsize = 8 if dtype == torch.float64 else 4
        # Device-memory guard.  With S the bytes of one padded bucket in the
        # compute dtype, a bucket step holds at its peak the scale-adjusted
        # coverage and its length-masked copy (2 S) and, beside them, either
        # the resident kernels' X scratch and the envelope refit's
        # temporaries (3 S) or, for a wide bucket, the (G, p, W) temporaries
        # of a round of the unfused trim loop (under 4 S; the streamed
        # kernel's X scratch, S, is freed before them): 6 S, beside the
        # resident upload form of every bucket (S, or S / 2 as int16).  A padded
        # bucket is capped at 1/12 of the device's memory, which leaves half
        # of it to the resident forms.  On a mesh the cap is the smallest
        # device's, over every process (all must pack the same buckets), and
        # is not scaled by the shards: shards may share a card, and the
        # one-device layout keeps a sharded fit bit-equal to that fit.  At
        # p > 32 a launch also holds a workspace (kernel 2's wide instance
        # at 33-128 samples, the panel instances past: sized by the genes in
        # flight), set aside first for each kind of kernel that a bucket of
        # the fit launches, at the widths the packer gives its genes.
        p = cov_mats[0].shape[0] if len(cov_mats) else 0
        conf = sorted(int(w) for w in self.eng_cfg.bucket_widths)
        widths = sorted({bucket_width(m.shape[1], conf) for m in cov_mats})
        kinds = cuda_nmf.workspace_kinds(p, widths, self.eng_cfg.use_kernels)
        total = min(_device_memory(d) - cuda_nmf.panel_workspace_bytes(
            p, d, kinds, genes=len(cov_mats), widths=widths)
            for d in set(self.mesh.devices))
        if self.mesh.process_count > 1:
            total = int(distributed.gather_rows(
                torch.tensor([total], device=self.device)).min())
        bucket_cap = max(total // 12, 512 << 20)
        t0 = time.perf_counter()
        # Integral small-valued coverage (read pileups) packs and uploads
        # as int16: half the float32 bytes; _bucket_step casts it back.
        as_i16 = dtype == torch.float32 and integral_int16able(cov_mats)
        pack_dtype = np.int16 if as_i16 else np.dtype(self.eng_cfg.dtype)
        self.timings["pack_scan"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._buckets = pack_buckets(
            cov_mats,
            bucket_widths=self.eng_cfg.bucket_widths,
            dtype=pack_dtype,
            max_genes_per_bucket=self.eng_cfg.max_genes_per_batch,
            max_bucket_bytes=bucket_cap,
            budget_itemsize=itemsize,
        )
        self.timings["pack_host"] = time.perf_counter() - t0
        # the packer never cuts a bucket below 8 genes: one whose genes are
        # so long that even that does not fit must not reach the device
        for b in self._buckets:
            need = 7 * b.F.size * itemsize
            if need > total:
                raise RuntimeError(
                    f"bucket of {b.F.shape[0]} genes x {b.F.shape[1]} samples "
                    f"x width {b.width} needs about {need / 2**30:.1f} GiB "
                    f"for one step (7 x {b.F.size * itemsize / 2**30:.2f} "
                    f"GiB), the device has {total / 2**30:.1f} GiB")

    def column_sharded(self, b: GeneBucket) -> bool:
        """True where bucket ``b`` is cut along its columns: a mesh of two
        or more shards and ``b.width >= seqpar_width`` (the JAX engine's
        rule, its engine.py:409-426), and at most
        ``cuda_nmf.COLS_MAX_P`` (128) samples.  The last is the port's shape
        rule: kernels 4c and 2c, the column-sharded route, have narrow and
        wide instances but no panel instance, so a bucket of more than 128
        samples is gene-sharded (kernel 4 at its panel instance) and counted
        in ``colshard_declined``; the plain versions follow the same rule,
        on every device."""
        return (self._past_seqpar_width(b)
                and b.F.shape[1] <= cuda_nmf.COLS_MAX_P)

    def _past_seqpar_width(self, b: GeneBucket) -> bool:
        """The JAX engine's rule alone: a mesh of two or more shards and a
        bucket at least ``seqpar_width`` wide."""
        return self.mesh.size > 1 and b.width >= self.eng_cfg.seqpar_width

    def _upload(self):
        """Upload this process's shards of every bucket (one shard a bucket
        on one device: its genes, or its columns where
        ``column_sharded``), skipping empty gene shards."""
        dtype = _torch_dtype(self.eng_cfg.dtype)
        mesh = self.mesh

        def upload_form(F):
            if F.dtype == np.int16:
                return F
            if dtype == torch.float32 and int16able(F):
                return F.astype(np.int16)
            return F

        t0 = time.perf_counter()
        self._shards, self._device_F, self._device_mask = [], [], []
        self._device_idx = []
        self._col_groups = []
        self.colshard_declined = sum(
            self._past_seqpar_width(b) and not self.column_sharded(b)
            for b in self._buckets)
        for bi, b in enumerate(self._buckets):
            if self.column_sharded(b):
                group = ColumnGroup(mesh, b.width, genes=b.n_real)
                self._col_groups.append(group)
                idx = torch.from_numpy(np.asarray(b.gene_indices, np.int64))
                for s, c, (F_d, m_d) in zip(
                        mesh.local_shards, group.columns(),
                        shard_columns(upload_form(b.F), b.len_mask(), mesh)):
                    self._shards.append(
                        _Shard(bi, 0, b.F.shape[0], mesh.device_of(s), c))
                    self._device_F.append(F_d)
                    self._device_mask.append(m_d)
                    self._device_idx.append(idx.to(self.device))
                continue
            self._col_groups.append(None)
            slots = shard_slots(b.F.shape[0], mesh.size)
            placed = shard_bucket(upload_form(b.F), b.len_mask(), mesh)
            for s, (F_d, m_d) in zip(mesh.local_shards, placed):
                a, c = slots[s]
                if c == a:
                    continue
                self._shards.append(_Shard(bi, a, c, mesh.device_of(s)))
                self._device_F.append(F_d)
                self._device_mask.append(m_d)
                self._device_idx.append(torch.from_numpy(
                    np.asarray(b.gene_indices[a:c], np.int64)).to(self.device))
        self._global_idx = None
        if mesh.process_count > 1:
            # the gene ids of every process's rows of the gene-sharded
            # buckets, in the order gather_rows concatenates them: by
            # process, then as self._shards
            k = len(mesh.devices)
            ids = [np.zeros(0, np.int64)]
            for r in range(mesh.process_count):
                for b in self._buckets:
                    if self.column_sharded(b):
                        continue
                    slots = shard_slots(b.F.shape[0], mesh.size)
                    ids += [b.gene_indices[a:c]
                            for a, c in slots[r * k:(r + 1) * k]]
            self._global_idx = torch.from_numpy(
                np.concatenate(ids).astype(np.int64)).to(self.device)
        self._sync()
        self.timings["upload"] = time.perf_counter() - t0

    def _gather_genes(self, parts: Sequence[torch.Tensor], fill, tail=(),
                      dtype=None) -> torch.Tensor:
        """The (n, *tail) tensor on ``self.device`` of per-gene rows, from
        the rows of this process's shards (``parts``, in ``self._shards``
        order) and, on a multi-process mesh, every other process's; padding
        slots are dropped.  A column-sharded bucket's rows are whole on each
        of its shards: the first shard's are taken, with no gather.
        ``tail``/``dtype`` shape an empty part list."""
        t0 = time.perf_counter()
        parts = [t.to(self.device) for t in parts]
        first = {}
        for k, sh in enumerate(self._shards):
            first.setdefault(sh.bucket, k)
        gene = [k for k, sh in enumerate(self._shards) if not sh.cols.sharded]
        col = [k for k in first.values() if self._shards[k].cols.sharded]
        if self._global_idx is None:
            keys, rows, idx = gene + col, [], []
        else:
            keys = col
            local = (torch.cat([parts[k] for k in gene]) if gene
                     else torch.empty((0,) + tuple(tail), dtype=dtype,
                                      device=self.device))
            rows, idx = [distributed.gather_rows(local)], [self._global_idx]
        out = _device_scatter([parts[k] for k in keys] + rows,
                              [self._device_idx[k] for k in keys] + idx,
                              self._n_genes, fill)
        self.timings["gather"] = (self.timings.get("gather", 0.0)
                                  + time.perf_counter() - t0)
        return out

    def _ds_starts(self, bucket: GeneBucket, iteration: int) -> torch.Tensor:
        """Per-gene systematic-sampling offsets, drawn for the global gene
        order once per iteration and looked up by gene id.  Without
        downsampling: zeros.  ``ds_compat="keyed"`` (the default) draws the
        JAX package's vector, ``randint(fold_in(PRNGKey(seed), iteration),
        (n_genes,), 0, rate)`` (its engine.py:535-545), with the numpy
        Threefry of ``core/prng.py``; it depends on (seed, iteration) alone,
        so a resumed fit needs no state.  ``"reference"``: the reference's
        exact stream, one ``RandomState(seed).choice(rate)`` per gene per
        iteration in input order (nmf.py:422,556).  Genes shorter than the
        rate diverge from the reference exactly as in the JAX package (its
        engine.py:532).  Returns the whole bucket's offsets, on every
        process: each shard takes its slice."""
        G = bucket.F.shape[0]
        if self.nmf_cfg.downsample_rate <= 1:
            if G not in self._ds_zero_cache:
                self._ds_zero_cache[G] = torch.zeros(
                    G, dtype=torch.int32, device=self.device)
            return self._ds_zero_cache[G]
        if self.nmf_cfg.ds_compat == "reference":
            if self._ds_ref_draws is None:
                self._ds_ref_draws = []
                self._ds_ref_rs = np.random.RandomState(
                    self.nmf_cfg.random_state)
            draws = self._ds_ref_draws
            while len(draws) <= iteration:
                rs = self._ds_ref_rs
                draws.append(np.array(
                    [rs.choice(self.nmf_cfg.downsample_rate)
                     for _ in range(self._n_genes)], np.int32))
            offsets = draws[iteration]
        else:
            if self._ds_cache is None or self._ds_cache[0] != iteration:
                self._ds_cache = (iteration, prng.downsample_offsets(
                    self.nmf_cfg.random_state, iteration, self._n_genes,
                    self.nmf_cfg.downsample_rate))
            offsets = self._ds_cache[1]
        starts = offsets[np.maximum(bucket.gene_indices, 0)]
        return torch.from_numpy(starts).to(self.device)

    # -- main loop -------------------------------------------------------
    def run(self, cov_dat: Mapping[str, np.ndarray],
            reads_dat: np.ndarray,
            checkpoint_dir: Optional[str] = None,
            reuse_device_data: bool = False) -> DegNormResult:
        """Fit DegNorm.  With ``checkpoint_dir``, the outer-loop state is
        saved there after every iteration (``degnorm_checkpoint.npz``, the
        JAX package's format), and a checkpoint found there for the same
        genes with iterations left resumes the loop after its iteration.

        ``reuse_device_data``: opt-in refit on the previous ``run``'s
        device-resident buckets — the packer and the upload are skipped.
        The CALLER asserts the coverage contents are unchanged; a cheap
        content-derived fingerprint guards against a different dataset, but
        changed values inside the same arrays are not fully detected.
        """
        genes = list(cov_dat.keys())
        cov_mats = [np.asarray(cov_dat[g]) for g in genes]
        n = len(cov_mats)
        self._n_genes = n
        if n == 0:
            raise ValueError("no coverage matrices supplied")
        if self.nmf_cfg.degnorm_iter < 1:
            raise ValueError("degnorm_iter must be >= 1")
        x_np = np.asarray(reads_dat, dtype=np.float64)
        if x_np.shape[0] != n:
            raise ValueError(
                "read count matrix rows != number of coverage matrices")
        if any(F.ndim != 2 for F in cov_mats):
            raise ValueError("all coverage matrices must be 2-d")
        p = cov_mats[0].shape[0]
        if self.nmf_cfg.downsample_rate > 1:
            if min(F.shape[1] for F in cov_mats) < self.nmf_cfg.downsample_rate:
                raise ValueError(
                    "downsample_rate exceeds the shortest gene length")

        t0 = time.perf_counter()
        self.timings = {}
        self._ds_ref_draws = None      # fresh offset stream per fit
        self._ds_cache = None
        fingerprint = _data_fingerprint(cov_mats, n)
        reuse = (reuse_device_data and self._buckets
                 and self._packed_fp == fingerprint)
        if not reuse:
            self._pack(cov_mats)
            self._packed_fp = fingerprint
        self.timings["pack"] = time.perf_counter() - t0
        dtype = _torch_dtype(self.eng_cfg.dtype)
        dev = self.device
        device_loop = self.outer_on_device()

        # ---- resume from a checkpoint? ----
        start_iter = 0
        ran_restored = np.zeros((n, 0), dtype=bool)
        ckpt = None
        if checkpoint_dir:
            ckpt = load_checkpoint(checkpoint_dir, genes)
            if ckpt and ckpt["iteration"] + 1 < self.nmf_cfg.degnorm_iter:
                start_iter = ckpt["iteration"] + 1
                ran_restored = np.asarray(
                    ckpt["ran_baseline_selection"][:, :start_iter], bool)
            else:
                ckpt = None

        # ---- initialization (nmf.py:512-535), float64 on the device or,
        # without device_loop, on the host ----
        t0 = time.perf_counter()
        x = torch.from_numpy(x_np).to(dev)
        state = None        # the host loop's GlobalState
        self.timings["gather"] = 0.0
        for group in self._col_groups:
            if group is not None:
                group.reductions, group.seconds = 0, 0.0
                group.gathers, group.gather_seconds = 0, 0.0
        by_bucket = [[k for k, sh in enumerate(self._shards) if sh.bucket == bi]
                     for bi in range(len(self._buckets))]
        if ckpt is not None:
            st = ckpt["state"]
            if device_loop:
                x_weighted, norm, scale = (
                    torch.from_numpy(np.array(a, np.float64)).to(dev)
                    for a in (st.x_weighted, st.norm_factors,
                              st.scale_factors))
            else:
                state = outer.GlobalState(*(np.array(a, np.float64)
                                            for a in st))
        else:
            init_out = [None] * len(self._shards)
            for bi, ks in enumerate(by_bucket):
                # a column-sharded bucket's shards reduce in lockstep
                done = run_steps(
                    _bucket_init_steps(
                        self._device_F[k], self._device_mask[k],
                        self.eng_cfg,
                        bucket_genes=self._buckets[bi].F.shape[0],
                        cols=self._shards[k].cols)
                    for k in ks)
                for k, r in zip(ks, done):
                    init_out[k] = r
            cov_sums = self._gather_genes([cs for cs, _ in init_out], 0.0,
                                          (p,), dtype)
            est_sums = self._gather_genes([es for _, es in init_out], 0.0,
                                          (p,), dtype)
            if device_loop:
                x_weighted, norm, _ = outer.device_init_state(cov_sums,
                                                              est_sums, x)
                scale = norm
            else:
                state = outer.init_state(outer.rho_from_ratio_svd(
                    _f64(cov_sums), _f64(est_sums)), x_np)
        # the per-phase timings are host clocks closed by a device sync;
        # next to a bucket step the sync costs nothing
        self._sync()
        self.timings["init"] = time.perf_counter() - t0

        # ---- DegNorm iterations (nmf.py:556-596) ----
        ran_cols = []
        self.trim_rounds = []
        rho = x_adj = None
        results: List[BucketResult] = []
        kernel_cfg = self.nmf_cfg.kernel_key()
        devices = sorted(set(self.mesh.devices), key=str)
        t0 = time.perf_counter()
        with self._profiler():
            for it in range(start_iter, self.nmf_cfg.degnorm_iter):
                t_it = time.perf_counter()
                final = it == self.nmf_cfg.degnorm_iter - 1
                if not device_loop:
                    scale = torch.from_numpy(state.scale_factors).to(dev)
                sf = {d: scale.to(dtype).to(d) for d in devices}
                results = [None] * len(self._shards)
                rounds = []
                for bi, ks in enumerate(by_bucket):
                    b = self._buckets[bi]
                    starts = self._ds_starts(b, it)
                    # every shard's work of this bucket is queued before the
                    # host reads any shard's trim state; column shards reduce
                    # in lockstep (run_steps)
                    done = run_steps(
                        _bucket_steps(
                            self._device_F[k], self._device_mask[k],
                            sf[self._shards[k].device],
                            starts[self._shards[k].start:self._shards[k].stop]
                            .to(self._shards[k].device),
                            kernel_cfg, self.eng_cfg, with_estimates=final,
                            bucket_genes=b.F.shape[0],
                            cols=self._shards[k].cols)
                        for k in ks)
                    for k, r in zip(ks, done):
                        results[k] = r
                    rounds.append(torch.stack(
                        [r.rounds_active.max().to(dev) for r in done]).max()
                        if done else torch.zeros((), dtype=torch.int32,
                                                 device=dev))
                rho_raw = self._gather_genes([r.rho for r in results], 0.0,
                                             (p,), dtype)
                if device_loop:
                    rho, x_adj, x_weighted, norm, scale = \
                        outer.device_iteration_math(rho_raw, x_weighted,
                                                    scale)
                else:
                    state = outer.iteration_update(state, _f64(rho_raw))
                ran_cols.append(self._gather_genes(
                    [r.ran_bs for r in results], False, (), torch.bool))
                self.trim_rounds.append(torch.stack(rounds).tolist())
                self._sync()
                self.timings[f"iter_{it}"] = time.perf_counter() - t_it
                if checkpoint_dir:
                    save_checkpoint(
                        checkpoint_dir, it,
                        outer.DeviceState(x, x_weighted, x_adj, rho, norm,
                                          scale).to_numpy()
                        if device_loop else state,
                        self._ran_matrix(ran_restored, ran_cols), genes)
        self.timings["iterations"] = time.perf_counter() - t0
        groups = [g for g in self._col_groups if g is not None]
        if groups:
            # host clock of the reductions across column shards (enqueue
            # time where the shards share a process; the collectives' waits
            # where they do not), and how many there were; the same of the
            # gather asks of kernels 4c and 2c (no tensor work where the
            # shards share a device)
            self.timings["reduce"] = sum(g.seconds for g in groups)
            self.reductions = sum(g.reductions for g in groups)
            self.timings["gram_gather"] = sum(g.gather_seconds for g in groups)
            self.gathers = sum(g.gathers for g in groups)

        self._last_results = results
        self._genes = genes
        self._cov_mats = cov_mats
        self._est_rows = None
        if self.mesh.process_count > 1:
            self._est_rows = self._gather_estimates(p)

        if device_loop:
            state = outer.DeviceState(x, x_weighted, x_adj, rho, norm,
                                      scale).to_numpy()
        rho64, xadj64, xw64 = state.rho, state.x_adj, state.x_weighted
        norm64, scale64 = state.norm_factors, state.scale_factors
        # estimates are computed on coverage scaled by the PRE-update scale
        # factors of the final iteration
        self._final_scale = scale64 / norm64
        ran_bs = self._ran_matrix(ran_restored, ran_cols)
        return DegNormResult(
            genes=genes, rho=rho64, x_adj=xadj64, scale_factors=scale64,
            norm_factors=norm64, ran_baseline_selection=ran_bs,
            x_weighted=xw64, engine=self)

    def outer_on_device(self) -> bool:
        """Whether the outer update runs on the device
        (``EngineConfig.device_loop``: None and True, and on a mesh that
        spans processes whatever it says) or on the host."""
        loop = self.eng_cfg.device_loop
        return loop is None or bool(loop) or self.mesh.process_count > 1

    def _profiler(self):
        """A torch.profiler trace of the iterations into
        ``eng_cfg.profile_dir`` (the JAX engine's jax.profiler trace), or
        nothing."""
        out = self.eng_cfg.profile_dir
        if not out:
            return contextlib.nullcontext()
        return _fit_trace(out, [d.type for d in self.mesh.devices],
                          self.mesh.process_index)

    def _gather_estimates(self, p: int):
        """A multi-process fit's estimate factors, gathered for the outputs
        (a collective: every process calls it).  Per bucket, host arrays
        (est_K, est_E, est_kind) over all its slots on the coordinator;
        None on the others, which return their result without estimates."""
        rows = []
        for bi, b in enumerate(self._buckets):
            W = b.F.shape[2]
            parts = [torch.cat([r.est_K.double(), r.est_E.double(),
                                r.est_kind.double()[:, None]], dim=1)
                     for r in self._bucket_estimates(bi)]
            if self._col_groups[bi] is not None:
                # whole on every process: every process's rows are the same
                parts = parts if self.mesh.process_index == 0 else []
            t0 = time.perf_counter()
            local = (torch.cat([t.to(self.device) for t in parts]) if parts
                     else torch.empty((0, p + W + 1), dtype=torch.float64,
                                      device=self.device))
            allrows = distributed.gather_rows(local)
            self.timings["gather"] += time.perf_counter() - t0
            if self.mesh.process_index == 0:
                a = allrows.cpu().numpy()
                rows.append((a[:, :p], a[:, p:p + W],
                             a[:, p + W].astype(np.int8)))
        return rows if self.mesh.process_index == 0 else None

    def _bucket_estimates(self, bi: int) -> List[BucketResult]:
        """Bucket ``bi``'s estimate factors from the last fit: its gene
        shards' results, in slot order, or, for a column-sharded bucket, one
        result whose ``est_E`` is joined along the columns from every shard
        (``ColumnGroup.cat_columns``, a collective on a multi-process
        mesh)."""
        mine = [r for sh, r in zip(self._shards, self._last_results)
                if sh.bucket == bi]
        group = self._col_groups[bi]
        if group is None:
            return mine
        return [mine[0]._replace(
            est_E=group.cat_columns([r.est_E for r in mine]))]

    @staticmethod
    def _ran_matrix(restored: np.ndarray, cols) -> np.ndarray:
        """(n, iterations) baseline-selection tracker: the columns of a
        resumed checkpoint, then one column a run iteration."""
        return np.concatenate(
            [restored] + [c.cpu().numpy().astype(bool)[:, None]
                          for c in cols], axis=1)

    # -- estimates -------------------------------------------------------
    def _materialize_estimates(self) -> List[np.ndarray]:
        """Reference ``run()`` returns the final iteration's estimated
        coverage matrices (nmf.py:601), computed on coverage scaled by the
        *pre-update* scale factors of that iteration."""
        if self._genes is None:
            raise ValueError("run() has not been called")
        rows = self._est_rows
        if rows is None:
            if self.mesh.process_count > 1:
                raise ValueError("the estimates of a multi-process fit are "
                                 "gathered on the coordinator (process 0)")
            rows = []
            for bi in range(len(self._buckets)):
                res = self._bucket_estimates(bi)
                rows.append(tuple(
                    np.concatenate([getattr(r, f).cpu().numpy() for r in res])
                    for f in ("est_K", "est_E", "est_kind")))
        n = len(self._genes)
        out: List[Optional[np.ndarray]] = [None] * n
        for b, (est_K, est_E, kinds) in zip(self._buckets, rows):
            est_K = est_K.astype(np.float64)
            est_E = est_E.astype(np.float64)
            for slot, gi in enumerate(b.gene_indices):
                if gi < 0:
                    continue
                F_adj = self._cov_mats[gi] / self._final_scale[:, None]
                out[gi] = materialize_estimate(
                    F_adj, int(b.lengths[slot]), est_K[slot], est_E[slot],
                    int(kinds[slot]))
        return out


@contextlib.contextmanager
def _fit_trace(out_dir: str, device_types, process_index: int):
    """torch.profiler over the fit's iterations, written on exit as a
    Chrome trace ``degnorm_fit[_<process>].pt.trace.json`` into
    ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if "cuda" in device_types:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    tag = f"_{process_index}" if process_index else ""
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(out_dir, f"degnorm_fit{tag}.pt.trace.json"))
