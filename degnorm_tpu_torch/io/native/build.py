"""Build + load the native host library: the BAM reader, the coverage
kernel, the int16 scan / pack / nibble encoder and the rANS / ITF8 decoders.

Compiled with g++ on first use into ``degnorm_tpu_torch/_build/``, keyed by
a hash of the sources and flags.  The build is safe across processes: it
holds an ``fcntl.flock`` on a lock file in the build directory while it
checks, compiles and loads, compiles into a per-process temporary file and
moves it into place with ``os.replace``.  Older revisions' libraries are removed only
while the lock is held.

A failed build raises (there is no silent fallback); callers that want the
numpy paths pass ``native=False`` or set ``DEGNORM_TPU_TORCH_NO_NATIVE=1``.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = tuple(os.path.join(_DIR, f) for f in (
    "bam_reader.cpp", "coverage_kernel.cpp", "pack_kernel.cpp",
    "rans_kernel.cpp"))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "_build")
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
          "-pthread"]
_PREFIX = "libdnhost_"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def native_disabled() -> bool:
    """True when the environment asks for the numpy paths."""
    return os.environ.get("DEGNORM_TPU_TORCH_NO_NATIVE", "0") == "1"


class DnBamData(ctypes.Structure):
    _fields_ = [
        ("n_reads", ctypes.c_int64),
        ("tid", ctypes.POINTER(ctypes.c_int32)),
        ("pos", ctypes.POINTER(ctypes.c_int32)),
        ("flag", ctypes.POINTER(ctypes.c_uint16)),
        ("rnext", ctypes.POINTER(ctypes.c_int32)),
        ("nh", ctypes.POINTER(ctypes.c_int32)),
        ("cigar_ops", ctypes.POINTER(ctypes.c_int8)),
        ("cigar_lens", ctypes.POINTER(ctypes.c_int32)),
        ("cigar_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("qnames", ctypes.POINTER(ctypes.c_char)),
        ("qname_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("pair_hash", ctypes.POINTER(ctypes.c_uint64)),
        ("mate_code", ctypes.POINTER(ctypes.c_int8)),
        ("n_refs", ctypes.c_int32),
        ("ref_names", ctypes.POINTER(ctypes.c_char)),
        ("ref_names_bytes", ctypes.c_int64),
        ("ref_lens", ctypes.POINTER(ctypes.c_int32)),
        ("error", ctypes.c_char_p),
    ]


def _so_name() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SRCS:
        with open(src, "rb") as f:
            h.update(f.read())
    return f"{_PREFIX}{h.hexdigest()[:12]}.so"


def _compile(so: str) -> None:
    """Compile into a file of this process, then move it into place."""
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, *_SRCS, "-o", tmp, "-lz"]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError("host library build failed: %s\n%s"
                               % (" ".join(cmd), r.stderr[-4000:]))
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _declare(lib: ctypes.CDLL) -> None:
    i8 = ctypes.POINTER(ctypes.c_int8)
    i32 = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.POINTER(ctypes.c_int64)
    u64 = ctypes.POINTER(ctypes.c_uint64)
    lib.dn_read_bam.restype = ctypes.c_int
    lib.dn_read_bam.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(DnBamData)]
    lib.dn_free_bam.restype = None
    lib.dn_free_bam.argtypes = [ctypes.POINTER(DnBamData)]
    lib.dn_parse_records.restype = ctypes.c_int
    lib.dn_parse_records.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(DnBamData), ctypes.c_int]
    lib.dn_chrom_coverage.restype = ctypes.c_int
    lib.dn_chrom_coverage.argtypes = [
        ctypes.c_int64, i32, i8, i32, i64, i32, i32, u64,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, i64, i64, i32,
        ctypes.c_int64, i64, i64, i64,
        ctypes.c_int64, i64, i64,
        i64, i64, i64, i64,
        ctypes.c_int,
    ]
    f32 = ctypes.POINTER(ctypes.c_float)
    f64 = ctypes.POINTER(ctypes.c_double)
    i16 = ctypes.POINTER(ctypes.c_int16)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.dn_f32_int16able.restype = ctypes.c_int
    lib.dn_f32_int16able.argtypes = [f32, ctypes.c_int64]
    lib.dn_f64_int16able.restype = ctypes.c_int
    lib.dn_f64_int16able.argtypes = [f64, ctypes.c_int64]
    lib.dn_int16able_many.restype = ctypes.c_int
    lib.dn_int16able_many.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), i64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int]
    lib.dn_pack_i16.restype = None
    lib.dn_pack_i16.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), i64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, i16, ctypes.c_int]
    lib.dn_nib_encode.restype = ctypes.c_int64
    lib.dn_nib_encode.argtypes = [
        i16, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i16, u8, i64, i32, ctypes.c_int64, ctypes.c_int]
    lib.dn_rans_uncompress.restype = ctypes.c_int64
    lib.dn_rans_uncompress.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, u8, ctypes.c_int64]
    lib.dn_itf8_scan.restype = ctypes.c_int64
    lib.dn_itf8_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, i32, ctypes.c_int64]
    lib.dn_pair_hash.restype = None
    lib.dn_pair_hash.argtypes = [
        ctypes.c_char_p, i64, i64, ctypes.c_int64, u64, i8]


def open_library(directory: str) -> ctypes.CDLL:
    """Build (if needed) and load the library in ``directory``, under the
    directory's lock file; raises when the build fails."""
    os.makedirs(directory, exist_ok=True)
    name = _so_name()
    so = os.path.join(directory, name)
    with open(os.path.join(directory, "libdnhost.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.isfile(so):
                _compile(so)
            lib = ctypes.CDLL(so)
            for f in os.listdir(directory):
                if f.startswith(_PREFIX) and f.endswith(".so") and f != name:
                    os.remove(os.path.join(directory, f))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    _declare(lib)
    return lib


def load_library() -> ctypes.CDLL:
    """The loaded host library of this process (built on first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = open_library(BUILD_DIR)
    return _LIB


def get_fn(name: str):
    """The named, declared symbol of the host library (built on first use;
    a failed build raises)."""
    return getattr(load_library(), name)
