"""Build + load the native BAM reader / coverage library of the host layer.

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
_SRCS = (os.path.join(_DIR, "bam_reader.cpp"),
         os.path.join(_DIR, "coverage_kernel.cpp"))
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
