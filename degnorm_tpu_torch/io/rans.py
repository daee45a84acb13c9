"""rANS 4x8 entropy codec (CRAM 3.0 block compression method 4).

This package's own copy of ``degnorm_tpu/io/rans.py``.  CRAM external
blocks are commonly rANS-compressed by htslib, so reading real-world .cram
files (the reference supports only .bam via pysam, ``loaders.py:64-70``;
CRAM is a completeness extension) requires this codec.  Implements the
CRAM 3.0 specification's rANS byte-stream format: four interleaved rANS
states, 12-bit normalized frequencies, order-0 and order-1 context models.

Pure-Python implementation; the decoder's default path is the host
library's io/native/rans_kernel.cpp (a failed build of it raises;
DEGNORM_TPU_TORCH_NO_NATIVE=1 or ``native=False`` takes the Python
decoder).  The encoder exists to build test fixtures and to let
io/cram.py write rANS-compressed blocks; interop with htslib is asserted
structurally (spec layout) and by roundtrip tests against the JAX
package's codec (tests/test_torch_cram.py).
"""
from __future__ import annotations

import ctypes
import struct
from typing import List, Optional, Tuple

import numpy as np

from degnorm_tpu_torch.io.native.build import get_fn, native_disabled

TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT          # 4096
RANS_BYTE_L = 1 << 23            # lower bound of the state interval
_MASK = TOTFREQ - 1


# ---------------------------------------------------------------------------
# frequency tables
# ---------------------------------------------------------------------------

def _normalize_freqs(counts: np.ndarray) -> np.ndarray:
    """Scale raw symbol counts to sum exactly TOTFREQ, keeping every
    observed symbol's frequency >= 1."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(256, dtype=np.int64)
    f = counts * TOTFREQ // total
    f[(counts > 0) & (f == 0)] = 1
    # Fix the residual: a positive remainder goes to the most frequent
    # symbol; a deficit (many rare symbols bumped to 1 can overshoot the
    # budget) is taken from the largest symbols without dropping any
    # below 1.  At most 256 symbols of >= 1 each always fit in TOTFREQ.
    resid = TOTFREQ - int(f.sum())
    if resid >= 0:
        f[int(np.argmax(f))] += resid
    else:
        while resid < 0:
            i = int(np.argmax(f))
            take = min(int(f[i]) - 1, -resid)
            if take <= 0:
                raise ValueError("degenerate frequency normalization")
            f[i] -= take
            resid += take
    return f


def _write_freqs_rle(out: bytearray, freqs: np.ndarray) -> None:
    """Order-0 table: ascending (symbol, freq) pairs with run-length
    elision of consecutive symbols; freq is 1 byte if <128 else 2 bytes
    with the high bit set; 0 terminates."""
    rle = 0
    last = -2
    syms = np.flatnonzero(freqs)
    present = np.zeros(256, bool)
    present[syms] = True
    for j in map(int, syms):
        if rle:
            rle -= 1
        else:
            out.append(j)
            if j == last + 1:
                # count the run of consecutive present symbols after j
                r = j + 1
                while r < 256 and present[r]:
                    r += 1
                rle = r - (j + 1)
                out.append(rle)
        f = int(freqs[j])
        if f < 128:
            out.append(f)
        else:
            out.append(128 | (f >> 8))
            out.append(f & 0xFF)
        last = j
    out.append(0)


def _read_freqs_rle(buf: bytes, off: int) -> Tuple[np.ndarray, int]:
    freqs = np.zeros(256, dtype=np.int64)
    rle = 0
    j = buf[off]
    off += 1
    last = -2
    while True:
        if rle:
            rle -= 1
        elif j == last + 1:
            rle = buf[off]
            off += 1
        f = buf[off]
        off += 1
        if f >= 128:
            f = ((f & 0x7F) << 8) | buf[off]
            off += 1
        freqs[j] = f
        last = j
        if rle:
            j = j + 1
            if j > 255:
                raise ValueError("rANS frequency-table run escapes the "
                                 "symbol alphabet")
        else:
            if off >= len(buf):
                raise ValueError("truncated rANS frequency table")
            j = buf[off]
            off += 1
            if j == 0:
                break
    return freqs, off


def _read_freqs_rle_outer(buf: bytes, off: int):
    """Order-1 table: RLE over context symbols, each holding an order-0
    style row.  Yields (context, row_freqs); returns the end offset."""
    rows = {}
    rle = 0
    i = buf[off]
    off += 1
    last = -2
    while True:
        if rle:
            rle -= 1
        elif i == last + 1:
            rle = buf[off]
            off += 1
        row, off = _read_freqs_rle(buf, off)
        rows[i] = row
        last = i
        if rle:
            i = i + 1
            if i > 255:
                raise ValueError("rANS O1 context run escapes the "
                                 "symbol alphabet")
        else:
            if off >= len(buf):
                raise ValueError("truncated rANS O1 frequency table")
            i = buf[off]
            off += 1
            if i == 0:
                break
    return rows, off


def _cum_and_lookup(freqs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    cum = np.zeros(257, dtype=np.int64)
    np.cumsum(freqs, out=cum[1:])
    if cum[256] > TOTFREQ:
        raise ValueError("rANS frequencies exceed TOTFREQ")
    lookup = np.zeros(TOTFREQ, dtype=np.uint8)
    for s in map(int, np.flatnonzero(freqs)):
        lookup[cum[s]:cum[s + 1]] = s
    return cum, lookup


# ---------------------------------------------------------------------------
# order-0
# ---------------------------------------------------------------------------

def _enc_renorm(x: int, freq: int, out: List[int]) -> int:
    x_max = ((RANS_BYTE_L >> TF_SHIFT) << 8) * freq
    while x >= x_max:
        out.append(x & 0xFF)
        x >>= 8
    return x


def _enc_put(x: int, freq: int, start: int, out: List[int]) -> int:
    x = _enc_renorm(x, freq, out)
    return ((x // freq) << TF_SHIFT) + (x % freq) + start


def _compress_o0(data: bytes) -> bytes:
    arr = np.frombuffer(data, dtype=np.uint8)
    freqs = _normalize_freqs(np.bincount(arr, minlength=256).astype(np.int64))
    cum, _ = _cum_and_lookup(freqs)
    table = bytearray()
    _write_freqs_rle(table, freqs)

    # encode back-to-front; state j owns bytes i with i % 4 == j
    states = [RANS_BYTE_L] * 4
    rev: List[int] = []              # renorm bytes, reversed stream
    for i in range(len(data) - 1, -1, -1):
        j = i & 3
        s = data[i]
        states[j] = _enc_put(states[j], int(freqs[s]), int(cum[s]), rev)
    head = b"".join(struct.pack("<I", st) for st in states)
    return bytes(table) + head + bytes(reversed(rev))


def _uncompress_o0(buf: bytes, out_sz: int) -> bytes:
    freqs, off = _read_freqs_rle(buf, 0)
    cum, lookup = _cum_and_lookup(freqs)
    states = list(struct.unpack_from("<4I", buf, off))
    ptr = off + 16
    out = bytearray(out_sz)
    n = len(buf)
    for i in range(out_sz):
        j = i & 3
        x = states[j]
        m = x & _MASK
        s = int(lookup[m])
        out[i] = s
        x = int(freqs[s]) * (x >> TF_SHIFT) + m - int(cum[s])
        while x < RANS_BYTE_L:
            if ptr >= n:
                raise ValueError("truncated rANS O0 stream")
            x = (x << 8) | buf[ptr]
            ptr += 1
        states[j] = x
    return bytes(out)


# ---------------------------------------------------------------------------
# order-1
# ---------------------------------------------------------------------------

def _o1_stats(data: bytes) -> np.ndarray:
    """Context counts F[prev][cur]; each of the 4 quarter-segments starts
    from context 0 (so the 4 decoder states are independent)."""
    n = len(data)
    isz4 = n >> 2
    F = np.zeros((256, 256), dtype=np.int64)
    arr = np.frombuffer(data, dtype=np.uint8)
    starts = [0, isz4, 2 * isz4, 3 * isz4]
    for st in starts:
        F[0, arr[st]] += 1
    # pairwise counts within each segment (segment 3 runs to the end)
    bounds = starts[1:] + [n]
    for st, en in zip(starts, bounds):
        if en - st >= 2:
            seg = arr[st:en]
            np.add.at(F, (seg[:-1], seg[1:]), 1)
    return F


def _compress_o1(data: bytes) -> bytes:
    n = len(data)
    isz4 = n >> 2
    if isz4 < 1:
        raise ValueError("input too short for order-1 (need >= 4 bytes)")
    F = _o1_stats(data)
    norm = np.zeros_like(F)
    cums = np.zeros((256, 257), dtype=np.int64)
    for ctx in map(int, np.flatnonzero(F.sum(axis=1))):
        norm[ctx] = _normalize_freqs(F[ctx])
        np.cumsum(norm[ctx], out=cums[ctx][1:])

    table = bytearray()
    present = F.sum(axis=1) > 0
    rle = 0
    last = -2
    for ctx in map(int, np.flatnonzero(present)):
        if rle:
            rle -= 1
        else:
            table.append(ctx)
            if ctx == last + 1:
                r = ctx + 1
                while r < 256 and present[r]:
                    r += 1
                rle = r - (ctx + 1)
                table.append(rle)
        _write_freqs_rle(table, norm[ctx])
        last = ctx
    table.append(0)

    # decode order: per i, states 0..3 emit out[j*isz4 + i]; the tail
    # (bytes >= 4*isz4) is decoded by state 3 last.  Encoding is the exact
    # reverse: tail first (state 3), then i = isz4-1 .. 0 with states
    # 3,2,1,0 inside each i.  Every byte's context is its predecessor
    # within the segment, 0 for segment heads.
    states = [RANS_BYTE_L] * 4
    rev: List[int] = []

    def put(j: int, ctx: int, sym: int) -> None:
        states[j] = _enc_put(states[j], int(norm[ctx][sym]),
                             int(cums[ctx][sym]), rev)

    for i in range(n - 1, 4 * isz4 - 1, -1):       # tail, state 3
        put(3, data[i - 1], data[i])
    for i in range(isz4 - 1, -1, -1):
        for j in (3, 2, 1, 0):
            pos = j * isz4 + i
            ctx = data[pos - 1] if i > 0 else 0
            put(j, ctx, data[pos])
    head = b"".join(struct.pack("<I", st) for st in states)
    return bytes(table) + head + bytes(reversed(rev))


def _uncompress_o1(buf: bytes, out_sz: int) -> bytes:
    rows, off = _read_freqs_rle_outer(buf, 0)
    cums, lookups, freqs = {}, {}, {}
    for ctx, row in rows.items():
        cums[ctx], lookups[ctx] = _cum_and_lookup(row)
        freqs[ctx] = row
    states = list(struct.unpack_from("<4I", buf, off))
    ptr = off + 16
    out = bytearray(out_sz)
    isz4 = out_sz >> 2
    last = [0, 0, 0, 0]
    n = len(buf)

    def step(j: int, pos: int, ptr: int) -> int:
        x = states[j]
        m = x & _MASK
        ctx = last[j]
        try:
            s = int(lookups[ctx][m])
        except KeyError:
            raise ValueError("rANS O1 stream references an absent context")
        out[pos] = s
        x = int(freqs[ctx][s]) * (x >> TF_SHIFT) + m - int(cums[ctx][s])
        while x < RANS_BYTE_L:
            if ptr >= n:
                raise ValueError("truncated rANS O1 stream")
            x = (x << 8) | buf[ptr]
            ptr += 1
        states[j] = x
        last[j] = s
        return ptr

    for i in range(isz4):
        for j in range(4):
            ptr = step(j, j * isz4 + i, ptr)
    for pos in range(4 * isz4, out_sz):            # tail, state 3
        ptr = step(3, pos, ptr)
    return bytes(out)


# ---------------------------------------------------------------------------
# public API (CRAM block payload framing)
# ---------------------------------------------------------------------------

def compress(data: bytes, order: int = 0) -> bytes:
    """Full CRAM rANS 4x8 payload: order byte, compressed/uncompressed
    sizes (uint32 LE), frequency table, state heads, byte stream."""
    if len(data) == 0:
        body = b""
        order = 0
    elif order == 0 or len(data) < 4:
        order = 0
        body = _compress_o0(data)
    else:
        body = _compress_o1(data)
    return (bytes([order]) + struct.pack("<II", len(body), len(data))
            + body)


def uncompress(payload: bytes, *, native: Optional[bool] = None) -> bytes:
    if len(payload) < 9:
        raise ValueError("rANS payload shorter than its 9-byte header")
    order = payload[0]
    comp_sz, out_sz = struct.unpack_from("<II", payload, 1)
    body = payload[9:9 + comp_sz]
    if len(body) < comp_sz:
        raise ValueError("rANS payload truncated")
    if out_sz == 0:
        return b""
    if native is None:
        native = not native_disabled()
    if native and order in (0, 1):
        return _uncompress_native(payload, out_sz)
    try:
        if order == 0:
            return _uncompress_o0(body, out_sz)
        if order == 1:
            return _uncompress_o1(body, out_sz)
    except IndexError:
        raise ValueError("truncated or corrupt rANS stream") from None
    raise ValueError(f"unknown rANS order {order}")


def _uncompress_native(payload: bytes, out_sz: int) -> bytes:
    """The host library's decoder (io/native/rans_kernel.cpp).  A corrupt
    stream raises, as the Python path would."""
    fn = get_fn("dn_rans_uncompress")
    out = np.empty(out_sz, dtype=np.uint8)
    n = fn(payload, len(payload),
           out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out_sz)
    if n != out_sz:
        raise ValueError("corrupt or truncated rANS stream (native decode)")
    return out.tobytes()
