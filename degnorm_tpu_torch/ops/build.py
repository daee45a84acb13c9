"""Builds the CUDA kernels of ``csrc/`` into one shared library and loads it.

The sources have a plain C interface (no PyTorch headers), so ``nvcc``
compiles them in seconds.  Each ``.cu`` file is compiled to an object by its
own ``nvcc`` process, all started together, then the objects are linked into
``_build/libdegnorm_<hash>.so``; the hash covers every source and header, so
an edited source rebuilds and an unchanged one is reused.  The library is
loaded with ``ctypes`` and every entry point gets its ``argtypes`` here.

Several processes may build at once (the ranks of a multi-process run each
build at first use): the build holds an ``fcntl.flock`` on a lock file in
the build directory, looks again for a finished library once it has the
lock, compiles into objects and a library named after its own process, and
moves the library into place.

Nothing runs at import time: ``get_lib()`` builds on first use and raises if
``nvcc`` is missing or a compile fails.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
build_info: Dict[str, object] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# name -> argtypes; every pointer and the stream are c_void_p (a bare Python
# int would be passed as a 32-bit C int and cut the pointer).
_SIGNATURES = {
    # F, mask, act, u0, X, K, E, u, G, p, W, nmf_iter, power_cold,
    # power_warm, warm_plain, tol, iters, threads, ws, ws_slots, stream
    "dn_nmf_masked": [_P] * 8 + [_I] * 7 + [_F, _P, _I, _P, _I, _P],
    # F, mask, act, u0, next, X, K, E, u, G, p, W, nmf_iter, power_cold,
    # power_warm, warm_plain, tol, iters, threads, stream
    "dn_nmf_masked_warp": [_P] * 9 + [_I] * 7 + [_F, _P, _I, _P],
    # F, f_is_i16, mask, cov_sums, est_sums, G, p, W, power_cold, cl,
    # threads, stage_kb, ws, ws_slots, stream
    "dn_ratio_rowsums": [_P, _I, _P, _P, _P] + [_I] * 7 + [_P, _I, _P],
    # Fm, bin_id, bin_count, K0, E, rho0, u0, n_hi, n_bins, active0,
    # X, colmask, K, rho, ran_bs, rounds_active, iters,
    # G, p, W, B, nmf_iter, power_resume, power_warm, warm_plain,
    # max_rounds, min_bins, min_gene_len, fast, tol, threads, ws, ws_slots,
    # stream
    "dn_trim_loop": [_P] * 17 + [_I] * 12 + [_F, _I, _P, _I, _P],
    # F, f_is_i16, mask, act, scale, u0, X, K, E, u, G, p, W, nmf_iter,
    # power_cold, power_warm, warm_plain, cl, threads, ws, ws_slots, stream
    # (ws: p > 128, the panel instance's workspace, else null and 0)
    "dn_nmf_streamed": [_P, _I] + [_P] * 8 + [_I] * 9 + [_P, _I, _P],
    # p, W, out (4 int32): the resident core's geometry (wide_res.cuh)
    "dn_res_geometry": [_I, _I, _P],
    # p, f_is_i16: the clusters the card holds at once of kernels 4 and 2 on
    # the cluster layout (stream_panel.cu, ratio_panel.cu)
    "dn_stream_panel_clusters": [_I, _I],
    "dn_ratio_panel_clusters": [_I, _I],
    # raw, scale, out, n, p, stream
    "dn_scaled_quotients": [_P, _P, _P, _I, _I, _P],
    # kernel 4c (and 2c's first launch): F, f_is_i16, mask, act, scale, X,
    # gram, bpart, tickets, ncols, G, p, W, nb, threads, stream
    "dn_cols_gram": [_P, _I] + [_P] * 8 + [_I] * 5 + [_P],
    # F, f_is_i16, mask, act, scale, X, parts, S, ncols, u_in, u_out, gram,
    # bpart, tickets, s_in, s_out, done, tol, it, G, p, W, nmf_iter,
    # n_squared, n_plain, nb, threads, stream
    "dn_cols_sweep": [_P, _I] + [_P] * 5 + [_I] + [_P] * 9 + [_F]
                     + [_I] * 9 + [_P],
    # mask, act, X, parts, S, ncols, u_in, K, E, u_out, s_in, s_fin, done,
    # tol, G, p, W, n_squared, n_plain, nb, threads, stream
    "dn_cols_finish": [_P] * 4 + [_I] + [_P] * 8 + [_F] + [_I] * 7 + [_P],
    # kernel 2c's second launch: F, f_is_i16, mask, parts, S, ncols, sums,
    # bpart, tickets, ws, G, p, W, power_cold, nb, threads, stream
    "dn_ratio_cols_sums": [_P, _I, _P, _P, _I] + [_P] * 5 + [_I] * 6 + [_P],
}


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of degnorm_tpu_torch are compiled "
        "on first use and need the CUDA toolkit")


def _sources():
    names = sorted(os.listdir(CSRC_DIR))
    cu = [n for n in names if n.endswith(".cu")]
    hdr = [n for n in names if n.endswith(".cuh")]
    return cu, hdr


def _source_hash(cu, hdr) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for n in cu + hdr:
        h.update(n.encode())
        with open(os.path.join(CSRC_DIR, n), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Start every command at once, wait for all, raise on the first
    failure with the compiler's output.  Returns (logs, seconds): each
    command's output and how long it ran."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [None] * len(cmds)
    secs = [0.0] * len(cmds)

    def wait(i):
        logs[i], _ = procs[i].communicate()
        secs[i] = time.perf_counter() - t0

    waiters = [threading.Thread(target=wait, args=(i,))
               for i in range(len(cmds))]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    for c, pr, out in zip(cmds, procs, logs):
        if pr.returncode != 0:
            raise RuntimeError("kernel build failed: %s\n%s"
                               % (" ".join(c), out))
    return logs, secs


def build(verbose: bool = False, build_dir: str = BUILD_DIR) -> str:
    """Compile the sources if no library with their hash exists in
    ``build_dir``; returns the library's path.  Safe across processes: see
    the module docstring."""
    cu, hdr = _sources()
    tag = _source_hash(cu, hdr)
    so_path = os.path.join(build_dir, f"libdegnorm_{tag}.so")
    if os.path.isfile(so_path):
        build_info.update(path=so_path, seconds=0.0, cached=True)
        return so_path
    nvcc = find_nvcc()
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "libdegnorm.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.isfile(so_path):     # another process built it
                build_info.update(path=so_path, seconds=0.0, cached=True)
                return so_path
            _compile(nvcc, cu, tag, so_path, verbose)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return so_path


def _compile(nvcc: str, cu, tag: str, so_path: str, verbose: bool) -> None:
    """Compile every source into an object of this process, link them into a
    library of this process, move it to ``so_path``; the objects and a
    library left by a failed step are removed."""
    t0 = time.perf_counter()
    extra = ["-Xptxas", "-v"] if verbose else []
    own = f"{tag}.{os.getpid()}"
    build_dir = os.path.dirname(so_path)
    objs = [os.path.join(build_dir, f"{n[:-3]}_{own}.o") for n in cu]
    tmp = f"{so_path}.{os.getpid()}.tmp"
    try:
        logs, secs = _run_all([[nvcc, *NVCC_FLAGS, *extra, "-c",
                                os.path.join(CSRC_DIR, n), "-o", o]
                               for n, o in zip(cu, objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, so_path)
    finally:
        for f in objs + [tmp]:
            if os.path.exists(f):
                os.remove(f)
    build_info.update(path=so_path, seconds=time.perf_counter() - t0,
                      cached=False, nvcc=nvcc, log="\n".join(logs),
                      source_seconds={n: round(t, 2)
                                      for n, t in zip(cu, secs)})


def get_lib(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build(verbose=verbose))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_launch(code: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error for its launch."""
    if code != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {code})")
