"""int16 eligibility of coverage: the rule by which the engine packs and
uploads coverage at half the float32 bytes.

This package's own copy of the first part of ``degnorm_tpu/data/encode.py``
(``int16able`` and its native scans); data/buckets.py and engine.py take
the rule from here.  The scans run in the host library
(io/native/pack_kernel.cpp); the numpy form stays the semantic source of
truth and runs under DEGNORM_TPU_TORCH_NO_NATIVE=1.

The rest of the JAX module, the delta/nibble-encoded upload, is not
carried over: on an H100's host link the direct int16 upload is faster
than encoding alone (PERF.md, PR 7; ROADMAP, "Not carried over").
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from degnorm_tpu_torch.io.native.build import get_fn, native_disabled

_NATIVE_FLOATS = (np.float32, np.float64)


def int16able(F: np.ndarray) -> bool:
    """True when one array is exactly representable as int16 coverage:
    integral values in [0, 32766].  The single source of the eligibility
    rule shared by the int16 bucket packer (data/buckets.py) and the
    engine's upload.

    A contiguous float32/float64 array takes the host library's single-pass
    scan (the numpy form makes three full passes of transients), unless
    DEGNORM_TPU_TORCH_NO_NATIVE=1."""
    if F.dtype.kind == "b":
        return True
    if F.dtype.kind in "iu":
        return F.min(initial=0) >= 0 and F.max(initial=0) < 32767
    if (not native_disabled() and F.dtype in _NATIVE_FLOATS
            and F.flags.c_contiguous):
        return _int16able_native(F)
    return (F.min(initial=0.0) >= 0.0 and F.max(initial=0.0) < 32767
            and bool(np.all(F == np.floor(F))))


def int16able_many_native(mats, threads: int = 4) -> Optional[bool]:
    """Batched int16able scan over many arrays in ONE native call; None
    when any array is not a contiguous float of the first array's dtype
    (the caller then scans array by array)."""
    if not mats:
        return True
    dt = mats[0].dtype
    if dt not in _NATIVE_FLOATS:
        return None
    if any(m.dtype != dt or not m.flags.c_contiguous for m in mats):
        return None
    fn = get_fn("dn_int16able_many")
    n = len(mats)
    ptrs = (ctypes.c_void_p * n)(*(m.ctypes.data for m in mats))
    sizes = np.fromiter((m.size for m in mats), np.int64, count=n)
    code = 0 if dt == np.float32 else 1
    return bool(fn(
        ptrs, sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, code, threads))


def _int16able_native(F: np.ndarray) -> bool:
    """Native single-pass int16able scan of a contiguous float32/float64
    array."""
    f32 = F.dtype == np.float32
    fn = get_fn("dn_f32_int16able" if f32 else "dn_f64_int16able")
    ptr_t = ctypes.POINTER(ctypes.c_float if f32 else ctypes.c_double)
    return bool(fn(F.ctypes.data_as(ptr_t), F.size))
