"""BAM alignment-file reading and writing, dependency-free.

The reference leans on pysam/htslib C code for BGZF inflation, record
decode, and .bai region fetch (reference ``loaders.py:64-70``,
``reads.py:223-245``; SURVEY.md §2.3).  This module decodes the BAM binary
format directly (SAM spec §4.2) into *columnar numpy arrays* — the shape the
vectorized coverage builder (io/coverage.py) wants — instead of per-read
Python objects.  The C++ reader (io/native/bam_reader.cpp) is the default
decode path; this module holds the format logic, the Python decoder and the
ctypes front-end.

The writer exists chiefly to synthesize test fixtures: the reference's
bundled .bam blobs are stripped from this snapshot (SURVEY.md §4), so parity
tests build their own files.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from degnorm_tpu_torch.io import bgzf
from degnorm_tpu_torch.io.native.build import native_disabled

BAM_MAGIC = b"BAM\x01"
CIGAR_OPS = "MIDNSHP=X"
_OP_INDEX = {c: i for i, c in enumerate(CIGAR_OPS)}
# ops that consume reference bases: M, D, N, =, X
REF_CONSUMING = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=np.int64)
# ops that are alignment matches: M, =, X
MATCH_OP = np.array([1, 0, 0, 0, 0, 0, 0, 1, 1], dtype=np.int64)

FLAG_UNMAPPED = 0x4
FLAG_PAIRED = 0x1


@dataclasses.dataclass
class BamHeader:
    text: str
    ref_names: List[str]
    ref_lengths: List[int]

    def as_frame(self):
        import pandas as pd
        return pd.DataFrame({"chr": self.ref_names,
                             "length": self.ref_lengths})


@dataclasses.dataclass
class ReadColumns:
    """Columnar alignment records for one chromosome (or a whole file).

    cigar runs are flattened: read i owns cigar_ops/cigar_lens rows
    [cigar_offsets[i], cigar_offsets[i+1]).
    """
    qnames: np.ndarray        # object array of str (or LazyQnames view
                              # from the native reader — materializes on
                              # np.asarray / tolist; index-compatible)
    tid: np.ndarray           # int32
    pos: np.ndarray           # int32, 0-based leftmost aligned base
    flag: np.ndarray          # uint16
    rnext: np.ndarray         # int32 (-1 = unset, matches pysam .rnext)
    nh: np.ndarray            # int32 NH aux tag (0 when absent)
    cigar_ops: np.ndarray     # int8 flattened op codes
    cigar_lens: np.ndarray    # int32 flattened run lengths
    cigar_offsets: np.ndarray  # int64, len = n_reads + 1
    # Optional precomputed pairing columns (filled by the native reader):
    # pair_hash = 64-bit hash of the qname sans trailing ".1"/".2" token,
    # mate_code = 1/2 for those suffixes, 0 otherwise.
    pair_hash: Optional[np.ndarray] = None
    mate_code: Optional[np.ndarray] = None
    # Ownership keepalive when the columns are zero-copy views over the
    # native reader's buffers (_cols_from_native).  Each such column ALSO
    # carries the owner on its own .base chain (_OwnedNativeView), so
    # freeing happens only after the last view is collected; the views
    # are read-only (writes raise).
    native_keep: Optional[object] = None

    def __len__(self):
        return len(self.pos)

    def cigar_string(self, i: int) -> str:
        s, e = self.cigar_offsets[i], self.cigar_offsets[i + 1]
        return "".join(f"{int(l)}{CIGAR_OPS[o]}"
                       for o, l in zip(self.cigar_ops[s:e],
                                       self.cigar_lens[s:e]))


def subset_columns(cols: ReadColumns, mask: np.ndarray) -> ReadColumns:
    """Rows of ``cols`` where ``mask`` is True, with the flattened cigar
    arrays and offsets rebuilt (and the optional pairing columns kept)."""
    if mask.all():
        # single-chromosome files hit this on the per-tid split: skip the
        # full-copy rebuild (repeat over cigar runs + fancy indexing)
        return cols
    idx = np.flatnonzero(mask)
    counts = np.diff(cols.cigar_offsets)
    keep_ops = np.repeat(mask, counts)
    return ReadColumns(
        qnames=cols.qnames[idx],
        tid=cols.tid[idx], pos=cols.pos[idx], flag=cols.flag[idx],
        rnext=cols.rnext[idx], nh=cols.nh[idx],
        cigar_ops=cols.cigar_ops[keep_ops],
        cigar_lens=cols.cigar_lens[keep_ops],
        cigar_offsets=np.concatenate(
            [[0], np.cumsum(counts[idx])]).astype(np.int64),
        pair_hash=(None if cols.pair_hash is None else cols.pair_hash[idx]),
        mate_code=(None if cols.mate_code is None else cols.mate_code[idx]),
    )


def _parse_aux_nh(buf: bytes, off: int, end: int) -> int:
    """Scan aux fields for the NH:i tag; returns 0 if absent."""
    _SIZES = {ord("A"): 1, ord("c"): 1, ord("C"): 1, ord("s"): 2,
              ord("S"): 2, ord("i"): 4, ord("I"): 4, ord("f"): 4}
    _FMT = {ord("c"): "<b", ord("C"): "<B", ord("s"): "<h", ord("S"): "<H",
            ord("i"): "<i", ord("I"): "<I"}
    while off + 3 <= end:
        tag = buf[off:off + 2]
        vtype = buf[off + 2]
        off += 3
        if vtype in _SIZES:
            if tag == b"NH":
                fmt = _FMT.get(vtype)
                if fmt:
                    return struct.unpack_from(fmt, buf, off)[0]
            off += _SIZES[vtype]
        elif vtype in (ord("Z"), ord("H")):
            nul = buf.index(b"\x00", off)
            off = nul + 1
        elif vtype == ord("B"):
            sub = buf[off]
            cnt = struct.unpack_from("<I", buf, off + 1)[0]
            off += 5 + cnt * _SIZES[sub]
        else:
            break
    return 0


def read_header(path: str, *, _initial_prefix: int = 1 << 20) -> BamHeader:
    """Parse the BAM header inflating only as many BGZF blocks as it
    spans (it lives at the file start; inflating the whole file for it
    would cost a full decode per header access).
    Reads the compressed file in growing prefixes so huge headers (many
    reference sequences) still parse.  ``_initial_prefix`` exists for
    tests to force the truncated-block growth path on small files."""
    import os as _os
    import zlib as _zlib
    fsize = _os.path.getsize(path)
    size = max(64, int(_initial_prefix))
    while True:
        with open(path, "rb") as f:
            raw = f.read(size)
        view = memoryview(raw)
        buf, off = b"", 0
        try:
            while off < len(raw):
                data, off = bgzf._read_block(view, off)
                buf += data
                try:
                    return _parse_header(buf)[0]
                except (struct.error, IndexError):
                    continue        # header spans further blocks
        except (ValueError, _zlib.error, struct.error, IndexError):
            # truncated final block at this prefix (zlib raises its own
            # error class when the cut lands mid-payload) — grow and retry
            pass
        if size >= fsize:
            # whole file inflated and still unparsable: surface the real
            # parse error on the complete buffer
            return _parse_header(bgzf.decompress(raw))[0]
        size *= 8


def _parse_header(buf: bytes) -> Tuple[BamHeader, int]:
    if buf[:4] != BAM_MAGIC:
        raise ValueError("not a BAM file (bad magic)")
    l_text = struct.unpack_from("<i", buf, 4)[0]
    text = buf[8:8 + l_text].rstrip(b"\x00").decode("utf-8", "replace")
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", buf, off)[0]
    off += 4
    names, lengths = [], []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", buf, off)[0]
        names.append(buf[off + 4: off + 4 + l_name - 1].decode())
        lengths.append(struct.unpack_from("<i", buf, off + 4 + l_name)[0])
        off += 8 + l_name
    return BamHeader(text=text, ref_names=names, ref_lengths=lengths), off


def read_bam(path: str, *, tid: Optional[int] = None,
             drop_unmapped: bool = True,
             native: Optional[bool] = None) -> Tuple[BamHeader, ReadColumns]:
    """Decode a whole BAM file into columnar arrays.

    ``tid``: keep only records on that reference id (like pysam
    fetch(chrom), reads.py:225, but streaming — no .bai required).

    Uses the C++ reader (io/native/) — parallel BGZF inflate +
    single-pass record decode; a failed build of it raises.  Set
    ``native=False`` (or DEGNORM_TPU_TORCH_NO_NATIVE=1) to take the
    Python implementation.
    """
    if native is None:
        native = not native_disabled()
    if native:
        return _read_bam_native(path, tid=tid, drop_unmapped=drop_unmapped)
    with open(path, "rb") as f:
        raw = f.read()
    buf = bgzf.decompress(raw)
    header, off = _parse_header(buf)
    cols = _parse_records(buf, off=off, tid=tid, drop_unmapped=drop_unmapped)
    return header, cols


def _parse_records(buf: bytes, off: int = 0, tid: Optional[int] = None,
                   drop_unmapped: bool = True,
                   pos_range: Optional[Tuple[int, int]] = None
                   ) -> ReadColumns:
    """Decode raw alignment records starting at ``off`` into columns.
    ``pos_range``: keep only records with pos in [beg, end)."""
    qnames: List[str] = []
    tids: List[int] = []
    poss: List[int] = []
    flags: List[int] = []
    rnexts: List[int] = []
    nhs: List[int] = []
    ops: List[int] = []
    lens: List[int] = []
    offsets: List[int] = [0]

    n = len(buf)
    while off + 4 <= n:
        block_size = struct.unpack_from("<i", buf, off)[0]
        start = off + 4
        (refID, pos, lrn, mapq, bin_, n_cigar, flag, l_seq, next_refID,
         next_pos, tlen) = struct.unpack_from("<iiBBHHHiiii", buf, start)
        off = start + block_size
        if tid is not None and refID != tid:
            continue
        if drop_unmapped and (flag & FLAG_UNMAPPED):
            continue
        if pos_range is not None and not (pos_range[0] <= pos < pos_range[1]):
            continue
        p = start + 32
        qname = buf[p: p + lrn - 1].decode()
        p += lrn
        cig = np.frombuffer(buf, dtype="<u4", count=n_cigar, offset=p)
        p += 4 * n_cigar
        seq_bytes = (l_seq + 1) // 2
        aux_start = p + seq_bytes + l_seq
        nh = _parse_aux_nh(buf, aux_start, off)

        qnames.append(qname)
        tids.append(refID)
        poss.append(pos)
        flags.append(flag)
        rnexts.append(next_refID)
        nhs.append(nh)
        ops.extend((cig & 0xF).tolist())
        lens.extend((cig >> 4).tolist())
        offsets.append(len(ops))

    return ReadColumns(
        qnames=np.array(qnames, dtype=object),
        tid=np.array(tids, dtype=np.int32),
        pos=np.array(poss, dtype=np.int32),
        flag=np.array(flags, dtype=np.uint16),
        rnext=np.array(rnexts, dtype=np.int32),
        nh=np.array(nhs, dtype=np.int32),
        cigar_ops=np.array(ops, dtype=np.int8),
        cigar_lens=np.array(lens, dtype=np.int32),
        cigar_offsets=np.array(offsets, dtype=np.int64),
    )


def _read_bam_native(path: str, *, tid: Optional[int],
                     drop_unmapped: bool) -> Tuple[BamHeader, ReadColumns]:
    """C++ fast path (io/native/bam_reader.cpp)."""
    import ctypes

    from degnorm_tpu_torch.io.native.build import DnBamData, load_library
    lib = load_library()
    data = DnBamData()
    rc = lib.dn_read_bam(path.encode(), -1 if tid is None else int(tid),
                         1 if drop_unmapped else 0, 0, ctypes.byref(data))
    if rc != 0:
        err = (data.error or b"?").decode(errors="replace")
        lib.dn_free_bam(ctypes.byref(data))
        raise ValueError(f"native BAM read failed: {err}")
    import ctypes as _ct
    ref_lens = (np.ctypeslib.as_array(
        data.ref_lens, shape=(int(data.n_refs),)).astype(np.int32)
        if data.n_refs else np.empty(0, np.int32))
    ref_blob = _ct.string_at(
        data.ref_names, int(data.ref_names_bytes)) if data.n_refs else b""
    ref_names = [s.decode() for s in ref_blob.split(b"\x00") if s]
    header = BamHeader(text="", ref_names=ref_names,
                       ref_lengths=[int(x) for x in ref_lens])
    # zero-copy handover: _cols_from_native takes ownership (frees on gc)
    return header, _cols_from_native(data, lib)


class LazyQnames:
    """Query names decoded on demand from the native reader's packed blob.

    Materializing n Python strings up front is a per-read Python loop, and
    the standard BAM pipeline never reads them —
    the native reader precomputes pair_hash/mate_code, which the coverage
    kernel uses for pairing. This wrapper keeps the raw blob + offset
    arrays and supports the object-ndarray operations the codebase uses:
    len/iter, int indexing (decodes one), array/mask/slice indexing
    (returns a new lazy view — subset_columns stays O(1) in string work),
    ``tolist``, and ``np.asarray`` via ``__array__`` (materializes and
    caches)."""

    def __init__(self, blob: bytes, starts: np.ndarray, ends: np.ndarray,
                 keep: Optional[object] = None):
        self._blob = blob
        self._starts = starts
        self._ends = ends
        # keepalive when starts/ends view native buffers (zero-copy
        # handover) — the blob itself is always an owned bytes copy
        self._keep = keep
        self._arr: Optional[np.ndarray] = None

    def _materialize(self) -> np.ndarray:
        if self._arr is None:
            blob = self._blob
            self._arr = np.array(
                [blob[s:e].decode() for s, e in
                 zip(self._starts.tolist(), self._ends.tolist())],
                dtype=object)
        return self._arr

    def __len__(self):
        return len(self._starts)

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            return self._blob[self._starts[int(i)]:self._ends[int(i)]].decode()
        return LazyQnames(self._blob, self._starts[i], self._ends[i],
                          keep=self._keep)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def tolist(self):
        return self._materialize().tolist()

    def __array__(self, dtype=None, copy=None):
        a = self._materialize()
        if dtype not in (None, object):
            return a.astype(dtype)       # astype always copies
        # honor the numpy>=2 copy request — callers may mutate the result,
        # which must not alias the shared cache
        return a.copy() if copy else a


class _OwnedNativeView:
    """``__array_interface__`` shim: ``np.asarray`` of this object yields a
    zero-copy view whose ``.base`` IS this object, which holds the
    _NativeOwner — so every derived view's base chain keeps the native
    allocation alive (freed-memory reads are impossible by construction,
    not by convention)."""

    def __init__(self, addr, count, dtype, owner):
        self._owner = owner
        self.__array_interface__ = {
            "shape": (int(count),),
            "typestr": np.dtype(dtype).str,
            "data": (int(addr), True),   # read-only
            "version": 3,
        }


class _NativeOwner:
    """Keeps a populated DnBamData's allocations alive while any column
    view references them (carried in ReadColumns.native_keep); frees the
    native buffers on collection."""

    def __init__(self, lib, data):
        import ctypes
        # prebind everything __del__ needs: at interpreter shutdown,
        # module globals (ctypes included) may already be torn down
        self._free = lib.dn_free_bam
        self._ref = ctypes.byref(data)
        self._data = data            # keeps the struct alive for _ref

    def __del__(self):               # pragma: no cover - gc timing
        free = getattr(self, "_free", None)
        self._free = None            # free exactly once
        if free is None:
            return
        try:
            free(self._ref)
        except Exception:
            pass


def _cols_from_native(data, lib=None) -> ReadColumns:
    """Columnar arrays out of a populated DnBamData.

    With ``lib``, the columns are ZERO-COPY views over the native buffers
    and ownership transfers to a keepalive stored on the ReadColumns (the
    caller must NOT free): a copy would move every column once more.
    Views are treated read-only by
    every consumer; row subsets (subset_columns, _filter_columns) fancy-
    index into fresh arrays, so derived data never aliases the native
    allocation.  Without ``lib``, columns are copied (caller frees)."""
    import ctypes

    n = int(data.n_reads)
    copy = lib is None
    keep = None if copy else _NativeOwner(lib, data)

    def arr(ptr, count, dtype):
        if count == 0:
            return np.empty(0, dtype)
        if copy:
            a = np.ctypeslib.as_array(ptr, shape=(count,))
            return a.astype(dtype, copy=True)
        # Zero-copy view whose .base chain REACHES THE OWNER: consumers
        # that retain a bare column (or a slice of one) past the
        # ReadColumns' lifetime keep the native allocation alive instead
        # of reading freed memory (np.ctypeslib.as_array's
        # base is only the ctypes array, enforcing the lifetime by
        # convention).  Marked read-only: the views are a contract.
        return np.asarray(_OwnedNativeView(
            ctypes.addressof(ptr.contents), count, dtype, keep))
    coff = arr(data.cigar_offsets, n + 1, np.int64)
    n_cig = int(coff[-1]) if n else 0
    qoff = arr(data.qname_offsets, n + 1, np.int64)
    qbytes = ctypes.string_at(data.qnames, int(qoff[-1])) if n else b""
    # lazy: the pipeline pairs reads through pair_hash, so the per-read
    # strings are usually never built (see LazyQnames).  The blob is a
    # real copy (bytes) either way, so qnames never dangle; the offset
    # views carry the keepalive.
    qnames = LazyQnames(qbytes, qoff[:-1], qoff[1:] - 1, keep=keep)
    return ReadColumns(
        qnames=qnames,
        tid=arr(data.tid, n, np.int32),
        pos=arr(data.pos, n, np.int32),
        flag=arr(data.flag, n, np.uint16),
        rnext=arr(data.rnext, n, np.int32),
        nh=arr(data.nh, n, np.int32),
        cigar_ops=arr(data.cigar_ops, n_cig, np.int8),
        cigar_lens=arr(data.cigar_lens, n_cig, np.int32),
        cigar_offsets=coff if n else np.array([0], np.int64),
        pair_hash=arr(data.pair_hash, n, np.uint64),
        mate_code=arr(data.mate_code, n, np.int8),
        native_keep=keep,
    )


def _parse_records_native(blob: bytes, *, tid: Optional[int],
                          drop_unmapped: bool = True,
                          pos_range: Optional[Tuple[int, int]] = None
                          ) -> ReadColumns:
    """Native decode of a headerless record blob (BAI region fetch)."""
    import ctypes

    from degnorm_tpu_torch.io.native.build import DnBamData, load_library
    lib = load_library()
    lo, hi = pos_range if pos_range is not None else (-(1 << 62), 1 << 62)
    data = DnBamData()
    rc = lib.dn_parse_records(
        blob, len(blob), -1 if tid is None else int(tid),
        1 if drop_unmapped else 0, int(lo), int(hi), ctypes.byref(data),
        0)   # 0 = hardware_concurrency (threaded decode, order-preserving)
    if rc != 0:
        err = (data.error or b"?").decode(errors="replace")
        lib.dn_free_bam(ctypes.byref(data))
        raise ValueError(f"native record parse failed: {err}")
    # zero-copy handover: _cols_from_native takes ownership (frees on gc)
    return _cols_from_native(data, lib)


# ---------------------------------------------------------------------------
# writer (test fixtures / simulation)
# ---------------------------------------------------------------------------

def _encode_cigar(cigar: str) -> bytes:
    out = b""
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            out += struct.pack("<I", (int(num) << 4) | _OP_INDEX[ch])
            num = ""
    return out


def _cigar_ref_len(cigar: str) -> int:
    """Reference-consumed length of a cigar string (M/D/N/=/X)."""
    total, num = 0, ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            if ch in "MDN=X":
                total += int(num)
            num = ""
    return total


def write_bam(path: str, ref_names: Sequence[str],
              ref_lengths: Sequence[int],
              records: Iterable[Tuple],
              *, nh_tags: bool = False,
              index_path: Optional[str] = None) -> None:
    """Write a BAM file (optionally with a .bai index).

    records: iterable of (qname, tid, pos0, flag, cigar_str, rnext[, nh]).
    Sequences/quals are omitted (l_seq = 0) — legal BAM, sufficient for
    coverage pipelines.  ``index_path``: write a BAI index there (the
    reference requires samtools for this, utils.py:149-173; io/bai.py
    implements the format natively).
    """
    text = "".join(f"@SQ\tSN:{n}\tLN:{l}\n"
                   for n, l in zip(ref_names, ref_lengths))
    hdr = BAM_MAGIC + struct.pack("<i", len(text)) + text.encode()
    hdr += struct.pack("<i", len(ref_names))
    for nm, ln in zip(ref_names, ref_lengths):
        b = nm.encode() + b"\x00"
        hdr += struct.pack("<i", len(b)) + b + struct.pack("<i", ln)

    body = [hdr]
    u_off = len(hdr)
    spans = []                       # (tid, pos0, ref_end, u_start, u_end)
    for rec in records:
        qname, tid_, pos0, flag, cigar, rnext = rec[:6]
        nh = rec[6] if len(rec) > 6 else None
        qb = qname.encode() + b"\x00"
        cig = _encode_cigar(cigar) if cigar else b""
        aux = b""
        if nh is not None:
            aux = b"NH" + b"i" + struct.pack("<i", nh)
        data = struct.pack(
            "<iiBBHHHiiii", tid_, pos0, len(qb), 60,
            0, len(cig) // 4, flag, 0, rnext, -1, 0)
        data += qb + cig + aux
        blob = struct.pack("<i", len(data)) + data
        body.append(blob)
        spans.append((tid_, pos0, pos0 + max(_cigar_ref_len(cigar), 1),
                      u_off, u_off + len(blob)))
        u_off += len(blob)

    payload = b"".join(body)
    compressed, table = bgzf.compress_with_table(payload)
    with open(path, "wb") as f:
        f.write(compressed)

    if index_path:
        from degnorm_tpu_torch.io.bai import write_bai
        per_ref = [[] for _ in ref_names]
        for tid_, pos0, rend, us, ue in spans:
            if 0 <= tid_ < len(per_ref):
                per_ref[tid_].append(
                    (pos0, rend, bgzf.virtual_offset(table, us),
                     bgzf.virtual_offset(table, ue)))
        write_bai(index_path, per_ref)


def read_head_qnames(path: str, n_records: int = 301) -> List[str]:
    """Query names of the first ``n_records`` mapped records, inflating
    BGZF blocks incrementally — the pairedness sniff (reference
    reads.py:178-203) without decoding the whole file (streaming ETL)."""
    qnames: List[str] = []
    data = bytearray()
    hdr_end = None
    parse_from = None
    off = 0
    with open(path, "rb") as f:
        raw = bytearray()
        while len(qnames) < n_records:
            chunk = f.read(1 << 20)
            if chunk:
                raw.extend(chunk)
            # inflate every complete block available (the memoryview is
            # released before the next raw.extend — a live view would make
            # the bytearray un-resizable and raise BufferError)
            progressed = False
            with memoryview(raw) as view:
                while True:
                    bsize = bgzf.block_size_at(view, off)
                    if bsize is None or off + bsize > len(raw):
                        break
                    blk, off = bgzf._read_block(view, off)
                    data.extend(blk)
                    progressed = True
            if hdr_end is None and len(data) >= 12:
                try:
                    _, hdr_end = _parse_header(bytes(data))
                except (struct.error, IndexError):
                    pass
            if hdr_end is not None:
                # parse newly complete records (parse_from persists)
                if parse_from is None:
                    parse_from = hdr_end
                buf = bytes(data)
                p = parse_from
                while p + 4 <= len(buf) and len(qnames) < n_records:
                    bs = struct.unpack_from("<i", buf, p)[0]
                    if p + 4 + bs > len(buf):
                        break
                    flag = struct.unpack_from("<H", buf, p + 4 + 14)[0]
                    lrn = buf[p + 4 + 8]
                    if not (flag & FLAG_UNMAPPED):
                        qnames.append(
                            buf[p + 4 + 32: p + 4 + 32 + lrn - 1].decode())
                    p = p + 4 + bs
                parse_from = p
            if not chunk and not progressed:
                break
    return qnames[:n_records]


def read_bam_region(path: str, bai_path: str, tid: int,
                    beg: int = 0, end: int = 1 << 29,
                    drop_unmapped: bool = True
                    ) -> Tuple[BamHeader, ReadColumns]:
    """BAI-driven region fetch: inflate only the BGZF blocks covering the
    region's chunks (the role pysam ``fetch`` plays at reads.py:225).

    NOTE: records are kept by START position in [beg, end) — unlike pysam
    fetch, a read starting before ``beg`` that overlaps into the region is
    NOT returned.  The pipeline only fetches whole chromosomes (beg=0), so
    both semantics coincide there; windowed callers wanting overlap
    semantics should widen ``beg`` by the max read span."""
    from degnorm_tpu_torch.io.bai import fetch_region_bytes, read_bai
    header = read_header(path)
    index = read_bai(bai_path)
    blob = fetch_region_bytes(path, index, tid, beg, end)
    return header, parse_region_blob(blob, tid=tid,
                                     drop_unmapped=drop_unmapped,
                                     pos_range=(beg, end))


def parse_region_blob(blob: bytes, *, tid: Optional[int],
                      drop_unmapped: bool = True,
                      pos_range: Optional[Tuple[int, int]] = None
                      ) -> ReadColumns:
    """Decode a headerless record blob (BAI region fetch): the C++ path,
    or the pure-Python one under DEGNORM_TPU_TORCH_NO_NATIVE=1 — the single
    place holding that policy for both region reads and the streaming
    ETL."""
    if not native_disabled():
        return _parse_records_native(blob, tid=tid,
                                     drop_unmapped=drop_unmapped,
                                     pos_range=pos_range)
    return _parse_records(blob, tid=tid, drop_unmapped=drop_unmapped,
                          pos_range=pos_range)
