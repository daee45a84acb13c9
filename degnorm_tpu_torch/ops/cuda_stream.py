"""The NMF-OA loop for wide buckets: CUDA kernel wrapper and its plain
PyTorch version.

Counterpart of ``degnorm_tpu/ops/pallas_stream.py`` (``nmf_masked_streamed``).
Same function as ``ops/cuda_nmf.py::nmf_masked_*`` for buckets outside the
resident kernels' gate (few genes, each p x W of half a megabyte and more),
with one more input form: with ``scale`` the coverage is the engine's RAW
device-resident tensor (int16 or float32) and the kernel casts, divides and
masks each column itself, in the order of ``engine._bucket_step``, so the
result equals that of the pre-adjusted float32 form bit for bit.

The kernel (``csrc/stream.cu``) spreads one gene over a cluster of thread
blocks; the wrapper takes the plain version only for a tensor that lies on
the CPU, and for a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from degnorm_tpu_torch.ops import cuda_nmf

# Launch counter (plain int): one is added where the kernel is launched.
stream_launches = 0

# Thread blocks a gene: DN_STREAM_CLUSTER of csrc/stream.cu, where it is a
# compile-time constant; here it only sizes the blocks.
CLUSTER = 8
MAX_THREADS = 512


def pick_threads(W: int) -> int:
    """Threads a block: about 8 columns a thread of a block's share of the
    width (W / CLUSTER).  Fewer threads lengthen a sweep, more of them
    lengthen the Gram reduction."""
    return min(MAX_THREADS, max(64, (W // (8 * CLUSTER) + 31) // 32 * 32))


def nmf_masked_streamed_plain(
    F: torch.Tensor,
    mask: torch.Tensor,
    *,
    nmf_iter: int,
    power_iters_cold: int = 30,
    power_iters_warm: int = 6,
    power_warm_plain: int = 0,
    gene_active: Optional[torch.Tensor] = None,
    u0: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version.  With ``scale`` (p,), ``F`` is the raw coverage (int16
    or floating) and A0 = F.to(scale.dtype) / scale * mask, in exactly that
    order; otherwise A0 = F * mask.  Then the loop of
    ``cuda_nmf.nmf_masked_plain``.  Returns (K, E, u); genes outside
    ``gene_active`` return zeros."""
    if scale is not None:
        F = F.to(scale.dtype) / scale[None, :, None]
    elif not F.dtype.is_floating_point:
        F = F.to(torch.float32)
    return cuda_nmf.nmf_loop_plain(
        F * mask.to(F.dtype)[:, None, :], mask, nmf_iter=nmf_iter,
        power_iters_cold=power_iters_cold, power_iters_warm=power_iters_warm,
        power_warm_plain=power_warm_plain, gene_active=gene_active, u0=u0)


def nmf_masked_streamed_cuda(
    F: torch.Tensor,
    mask: torch.Tensor,
    *,
    nmf_iter: int,
    power_iters_cold: int = 30,
    power_iters_warm: int = 6,
    power_warm_plain: int = 0,
    gene_active: Optional[torch.Tensor] = None,
    u0: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel wrapper with ``nmf_masked_streamed_plain``'s signature: one
    cluster of ``CLUSTER`` thread blocks per gene runs the whole loop
    (csrc/stream.cu).  Takes int16 or float32 coverage of any width and
    2 <= p <= 32.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    if F.device.type == "cpu":
        return nmf_masked_streamed_plain(
            F, mask, nmf_iter=nmf_iter, power_iters_cold=power_iters_cold,
            power_iters_warm=power_iters_warm,
            power_warm_plain=power_warm_plain, gene_active=gene_active,
            u0=u0, scale=scale)
    global stream_launches
    from degnorm_tpu_torch.ops.build import check_launch, get_lib
    name = "nmf_masked_streamed_cuda"
    if F.dtype not in (torch.float32, torch.int16):
        raise TypeError(f"{name}: coverage must be float32 or int16, "
                        f"got {F.dtype}")
    if not F.is_contiguous():
        raise ValueError(f"{name}: coverage tensor must be contiguous")
    G, p, W = F.shape
    if p > cuda_nmf.MAX_P or p < 2:
        raise ValueError(
            f"{name}: p={p} outside the kernels' range 2..{cuda_nmf.MAX_P}")
    if scale is not None and tuple(scale.shape) != (p,):
        raise ValueError(f"{name}: scale must have shape ({p},), "
                         f"got {tuple(scale.shape)}")
    f32 = torch.float32
    dev = F.device
    m8 = cuda_nmf._as_u8(mask)
    act8 = None if gene_active is None else cuda_nmf._as_u8(gene_active)
    u0c = None if u0 is None else u0.to(f32).contiguous()
    sc = None if scale is None else scale.to(f32).contiguous()
    # Scratch and converted inputs may be dropped as soon as this returns:
    # the caching allocator reuses a block only for work queued later on
    # this same stream, after the kernel.
    X = torch.empty((G, p, W), dtype=f32, device=dev)            # scratch
    K = torch.empty((G, p), dtype=f32, device=dev)
    E = torch.empty((G, W), dtype=f32, device=dev)
    u = torch.empty((G, p), dtype=f32, device=dev)
    if G == 0:
        return K, E, u
    ptr = cuda_nmf._ptr
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = get_lib().dn_nmf_streamed(
            F.data_ptr(), int(F.dtype == torch.int16), m8.data_ptr(),
            ptr(act8), ptr(sc), ptr(u0c), X.data_ptr(), K.data_ptr(),
            E.data_ptr(), u.data_ptr(), G, p, W, int(nmf_iter),
            int(power_iters_cold), int(power_iters_warm),
            int(power_warm_plain), pick_threads(W), stream)
    check_launch(code, "dn_nmf_streamed")
    stream_launches += 1
    return K, E, u
