"""BGZF (blocked gzip) codec.

The reference delegates BGZF to pysam/htslib's C code (SURVEY.md §2.3).
Here: a self-contained implementation — reading via block-wise raw-deflate
inflation, writing via spec-compliant 64 KB blocks with the BC extra
subfield and the canonical EOF marker, so files interoperate with
samtools/htslib.
"""
from __future__ import annotations

import struct
import zlib
from typing import Tuple

# canonical 28-byte BGZF EOF block (SAM spec §4.1.2)
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

_HDR = struct.Struct("<4BI2B2H")   # magic..XLEN
_MAX_BLOCK_PAYLOAD = 65280          # keep compressed block < 65536


def block_size_at(buf, off: int):
    """Total compressed size of the BGZF block at ``off`` (from its BC
    extra subfield), or None when the buffered bytes are too short to
    decide — the shared primitive of every incremental reader."""
    if off + 18 > len(buf):
        return None
    xlen = struct.unpack_from("<H", buf, off + 10)[0]
    if off + 12 + xlen > len(buf):
        return None
    extra = bytes(buf[off + 12: off + 12 + xlen])
    i = 0
    while i + 4 <= len(extra):
        si1, si2, slen = extra[i], extra[i + 1], struct.unpack_from(
            "<H", extra, i + 2)[0]
        if si1 == 66 and si2 == 67 and slen == 2:
            return struct.unpack_from("<H", extra, i + 4)[0] + 1
        i += 4 + slen
    raise ValueError(f"gzip member at {off} lacks BGZF BC subfield")


def _read_block(buf: memoryview, off: int) -> Tuple[bytes, int]:
    """Decode one BGZF block at byte offset ``off``; returns (data, next_off)."""
    if buf[off] != 0x1F or buf[off + 1] != 0x8B:
        raise ValueError(f"bad gzip magic at offset {off}")
    bsize = block_size_at(buf, off)
    if bsize is None:
        raise ValueError(f"truncated BGZF block at offset {off}")
    xlen = struct.unpack_from("<H", buf, off + 10)[0]
    cdata_start = off + 12 + xlen
    cdata_end = off + bsize - 8
    data = zlib.decompress(bytes(buf[cdata_start:cdata_end]), wbits=-15)
    isize = struct.unpack_from("<I", buf, off + bsize - 4)[0]
    if len(data) != isize:
        raise ValueError(f"BGZF block at {off}: ISIZE mismatch")
    return data, off + bsize


def decompress(raw: bytes) -> bytes:
    """Inflate a whole BGZF byte string."""
    out = []
    view = memoryview(raw)
    off = 0
    while off < len(raw):
        data, off = _read_block(view, off)
        out.append(data)
    return b"".join(out)


def decompress_file(path: str) -> bytes:
    with open(path, "rb") as f:
        return decompress(f.read())


def decompress_with_table(raw: bytes):
    """Inflate a whole BGZF byte string and return (data, table) where
    table = [(uncompressed_start, compressed_start, uncompressed_len), ...]
    — the read-side counterpart of ``compress_with_table``, enabling
    uncompressed-offset → virtual-offset mapping (BAI construction)."""
    out = []
    table = []
    view = memoryview(raw)
    off = 0
    u_off = 0
    while off < len(raw):
        data, nxt = _read_block(view, off)
        table.append((u_off, off, len(data)))
        out.append(data)
        u_off += len(data)
        off = nxt
    return b"".join(out), table


def _write_block(payload: bytes) -> bytes:
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = comp.compress(payload) + comp.flush()
    bsize = len(cdata) + 26   # 12 hdr + 6 extra + cdata + 8 trailer
    # magic1, magic2, CM, FLG(FEXTRA), MTIME, XFL, OS, XLEN, SI1|SI2 ("BC")
    header = _HDR.pack(0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6, 0x4342)
    return (header + struct.pack("<2H", 2, bsize - 1) + cdata
            + struct.pack("<II", zlib.crc32(payload), len(payload)))


def compress(data: bytes, *, eof: bool = True) -> bytes:
    """Deflate ``data`` into BGZF blocks (+ EOF marker)."""
    return compress_with_table(data, eof=eof)[0]


def compress_with_table(data: bytes, *, eof: bool = True):
    """Compress and also return the block table
    [(uncompressed_start, compressed_start, uncompressed_len), ...] —
    enough to map any uncompressed offset to a BGZF virtual offset
    ((compressed_block_start << 16) | intra-block offset)."""
    out = []
    table = []
    c_off = 0
    for i in range(0, len(data), _MAX_BLOCK_PAYLOAD):
        payload = data[i:i + _MAX_BLOCK_PAYLOAD]
        blk = _write_block(payload)
        table.append((i, c_off, len(payload)))
        out.append(blk)
        c_off += len(blk)
    if not data:
        out.append(_write_block(b""))
        table.append((0, 0, 0))
    if eof:
        out.append(BGZF_EOF)
    return b"".join(out), table


def virtual_offset(table, u_offset: int) -> int:
    """Map an uncompressed byte offset to a BGZF virtual offset using a
    block table from compress_with_table."""
    import bisect
    starts = [t[0] for t in table]
    i = bisect.bisect_right(starts, u_offset) - 1
    u0, c0, _ = table[max(i, 0)]
    return (c0 << 16) | (u_offset - u0)
