"""Length-bucket packing: ragged per-gene coverage matrices -> padded batches.

This package's own copy of ``degnorm_tpu/data/buckets.py``.  The reference
keeps a Python list of ragged (p x L_i) arrays and loops genes on host
threads (nmf.py:126-140); the engine instead packs genes into a small number
of fixed-width buckets, one thread block per gene in the kernels, and the
masked kernels are exact under zero padding.

Gene length is power-law distributed, so bucket widths are geometric.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence

import numpy as np

from degnorm_tpu_torch.data.encode import int16able, int16able_many_native
from degnorm_tpu_torch.io.native.build import get_fn, native_disabled


def integral_int16able(cov_mats: Sequence[np.ndarray],
                       chunk: int = 1024) -> bool:
    """True when every matrix is exactly representable as int16 (integral,
    in [0, 32766]) — buys packing and uploading the padded buckets at half
    the float32 bytes.  The per-array rule is data/encode.py::int16able.

    Uniform contiguous float inputs (the common case) take one batched
    native call on 4 threads — per-array dispatch costs more than the scan
    itself at 20k+ genes; other inputs are scanned array by array on 4
    threads.  Under DEGNORM_TPU_TORCH_NO_NATIVE=1 the ragged inputs
    are scanned with numpy ``chunk`` matrices at a time as one flat array
    (the chunk bounds the transient copy)."""
    if not native_disabled():
        verdict = int16able_many_native(cov_mats, threads=4)
        if verdict is not None:
            return verdict
        with ThreadPoolExecutor(4) as ex:
            return all(ex.map(int16able, cov_mats, chunksize=256))
    for s in range(0, len(cov_mats), chunk):
        flat = np.concatenate([np.asarray(m).ravel()
                               for m in cov_mats[s:s + chunk]])
        if not int16able(flat):
            return False
    return True


def _pack_i16_native(mats, lengths: np.ndarray, F: np.ndarray) -> bool:
    """Cast-pack ragged float mats into the leading rows of the padded
    int16 bucket F with one native call (values must already be validated
    int16able — integral_int16able gates the int16 pack dtype upstream).
    False when the call does not apply: native code disabled, or a matrix
    of another dtype, shape or layout (the caller then fills with numpy,
    whose slice assignment raises on a row-count mismatch; the raw C kernel
    must never read past a differently-shaped buffer)."""
    if F.dtype != np.int16 or not mats or native_disabled():
        return False
    dt = mats[0].dtype
    if dt not in (np.float32, np.float64):
        return False
    p = F.shape[1]
    if any(m.dtype != dt or m.ndim != 2 or m.shape[0] != p
           or not m.flags.c_contiguous for m in mats):
        return False
    fn = get_fn("dn_pack_i16")
    n = len(mats)
    ptrs = (ctypes.c_void_p * n)(*(m.ctypes.data for m in mats))
    lens = np.ascontiguousarray(lengths[:n], np.int64)
    fn(ptrs, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
       n, F.shape[1], F.shape[2], 0 if dt == np.float32 else 1,
       F.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
       min(4, os.cpu_count() or 1))
    return True


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _quantize_down(c: int) -> int:
    """Largest gene-count ladder value (64, 96, 128, 192, 256, ...) <= c,
    so byte-capped chunks quantize UP to at most the cap itself (without
    this, _quantize_count could inflate a cap-sized chunk 1.5x past the
    engine's device-memory guard)."""
    import math
    if c < 64:
        return c
    b = 1 << int(math.floor(math.log2(c)))
    return b + b // 2 if b + b // 2 <= c else b


def _quantize_count(g: int) -> int:
    """Round a gene count up to a coarse ladder (64, 96, 128, 192, 256, ...)
    so bucket shapes recur across datasets and runs (the same ladder as the
    JAX package, so both pack identical buckets).  Padding genes bail out of
    the kernels immediately; worst-case padding is 50%, typical <20%."""
    import math
    if g <= 64:
        return 64
    b = 1 << int(math.floor(math.log2(g)))
    for cand in (b, b + b // 2, 2 * b):
        if g <= cand:
            return cand
    return 2 * b


@dataclasses.dataclass
class GeneBucket:
    """A padded batch of same-width genes.

    F: (G, p, W) float array, gene i padded with zeros beyond lengths[i].
    gene_indices: (G,) indices into the engine's global gene order; -1 marks
      padding genes (all-zero rows added to reach a device-friendly count).
    lengths: (G,) true gene lengths.
    """
    width: int
    F: np.ndarray
    lengths: np.ndarray
    gene_indices: np.ndarray

    @property
    def n_real(self) -> int:
        return int(np.sum(self.gene_indices >= 0))

    def len_mask(self) -> np.ndarray:
        return np.arange(self.width)[None, :] < self.lengths[:, None]


def bucket_width(L: int, widths: Sequence[int]) -> int:
    """The width of the bucket a gene of L columns goes to: the smallest of
    the sorted ``widths`` that holds it, else L rounded up to 128."""
    return next((w for w in widths if L <= w), _round_up(L, 128))


def pack_buckets(
    cov_mats: Sequence[np.ndarray],
    bucket_widths: Sequence[int] = (256, 512, 1024, 2048, 4096, 8192, 16384, 65536),
    *,
    dtype=np.float32,
    pad_genes_to: int = 1,
    max_genes_per_bucket: int = 0,
    quantize_genes: bool = True,
    max_bucket_bytes: int = 0,
    budget_itemsize: int = 0,
) -> List[GeneBucket]:
    """Pack ragged (p x L_i) matrices into padded GeneBuckets.

    Genes longer than the largest configured width get ad-hoc buckets of
    width round_up(L, 128).  ``pad_genes_to`` pads each bucket's gene count
    up to a multiple (for even device sharding); padding genes are all-zero
    and marked with gene_index -1 (they bail out of baseline selection with
    rho == 0 and are dropped at unpack time).
    """
    if not cov_mats:
        return []
    p = cov_mats[0].shape[0]
    widths = sorted(int(w) for w in bucket_widths)
    groups: Dict[int, List[int]] = {}
    for i, F in enumerate(cov_mats):
        groups.setdefault(bucket_width(F.shape[1], widths), []).append(i)

    buckets: List[GeneBucket] = []
    # max_bucket_bytes guards the DEVICE footprint, where the bucket lives
    # in the compute dtype — size the cap by that itemsize, not the
    # (possibly narrower) host packing dtype.
    itemsize = budget_itemsize or np.dtype(dtype).itemsize
    for w in sorted(groups):
        idxs = groups[w]
        cap = max_genes_per_bucket if max_genes_per_bucket > 0 else len(idxs)
        quantize_w = quantize_genes
        if max_bucket_bytes > 0:
            # keep each padded (G, p, w) array under the device-memory cap:
            # the FINAL padded gene count (chunk -> pad_genes_to multiple ->
            # quantization ladder -> pad multiple again) must not round back
            # up past the cap the engine's device-memory guard computed
            byte_cap = max(8, int(max_bucket_bytes // (p * w * itemsize)))
            padm = max(pad_genes_to, 1)
            c = byte_cap
            if quantize_w:
                # largest ladder value whose pad-rounded form fits the cap;
                # a chunk of at most (L // padm) * padm genes then pads to
                # exactly L and never rounds past the cap
                L = _quantize_down(byte_cap)
                while L >= 64 and _round_up(L, padm) > byte_cap:
                    L = _quantize_down(L - 1)
                if L >= 64 and (L // padm) * padm >= 8:
                    c = (L // padm) * padm
                else:
                    quantize_w = False
            if not quantize_w:
                # pad_genes_to is a hard floor (mesh divisibility)
                c = max(padm, (byte_cap // padm) * padm)
            cap = min(cap, c)
        chunks = [idxs[s:s + cap] for s in range(0, len(idxs), cap)] \
            if cap < len(idxs) else [idxs]
        for chunk in chunks:
            g = len(chunk)
            g_pad = _round_up(g, max(pad_genes_to, 1))
            if quantize_w:
                g_pad = _round_up(_quantize_count(g_pad),
                                  max(pad_genes_to, 1))
            F = np.zeros((g_pad, p, w), dtype=dtype)
            lengths = np.zeros(g_pad, dtype=np.int32)
            gene_indices = np.full(g_pad, -1, dtype=np.int32)
            for slot, gi in enumerate(chunk):
                lengths[slot] = cov_mats[gi].shape[1]
                gene_indices[slot] = gi

            def fill(lo_hi):
                lo, hi = lo_hi
                for slot in range(lo, hi):
                    gi = chunk[slot]
                    F[slot, :, :cov_mats[gi].shape[1]] = cov_mats[gi]

            # int16 buckets from float mats (the post-scan common case)
            # cast-pack in one native call; otherwise slice assignment is a
            # (casting) memcpy that releases the GIL, so thread the copy
            # loop — page-fault zeroing of the padded buffer and the copies
            # themselves both parallelize.
            if not _pack_i16_native([cov_mats[gi] for gi in chunk],
                                    lengths[:g], F):
                n_threads = min(4, max(1, g // 512))
                bounds = np.linspace(0, g, n_threads + 1).astype(int)
                if n_threads > 1:
                    with ThreadPoolExecutor(n_threads) as ex:
                        list(ex.map(fill, zip(bounds[:-1], bounds[1:])))
                else:
                    fill((0, g))
            # zero-length padding genes break nothing, but give them length 1
            # so len_mask arithmetic stays trivially valid.
            lengths[g:] = 1
            buckets.append(GeneBucket(width=w, F=F, lengths=lengths,
                                      gene_indices=gene_indices))
    return buckets


def scatter_rows(out: np.ndarray, rows: np.ndarray, gene_indices: np.ndarray):
    """Write bucket-level per-gene rows back into a global (n, ...) array,
    skipping padding genes."""
    real = gene_indices >= 0
    out[gene_indices[real]] = rows[real]
    return out
