"""Multi-process runs on ``torch.distributed``: the counterpart of
``degnorm_tpu/parallel/distributed.py`` (itself the replacement of the
reference's second MPI binary, ``__main_mpi__.py``).

The same single command runs in every process.  Each process drives one
device and holds one shard of every bucket (parallel/sharded.py); the ETL is
split by sample over the processes and shared through the output directory;
the coordinator (process 0) owns every artifact.

Launch each process with

    DEGNORM_TPU_COORDINATOR=host0:8476 DEGNORM_TPU_NUM_PROCESSES=2 \\
    DEGNORM_TPU_PROCESS_ID=<i> degnorm-tpu-torch --bam-files ... --multihost

or under ``torchrun`` (its ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK`` are read when the three variables above
are unset).  Process ``r`` drives ``cuda:LOCAL_RANK`` where torchrun sets
it, else ``cuda:{r % device_count}``.  The backend is NCCL on CUDA devices
and gloo on the CPU; ``DEGNORM_TPU_TORCH_DIST_BACKEND=gloo`` asks for gloo
on CUDA devices, which ranks that share one card need (NCCL refuses them).
"""
from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from degnorm_tpu_torch.parallel.sharded import GeneMesh

log = logging.getLogger("degnorm_tpu_torch")

BACKEND_ENV = "DEGNORM_TPU_TORCH_DIST_BACKEND"


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    return process_index() == 0


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device: str = "cuda") -> None:
    """Join the process group from the arguments or the environment (see
    the module docstring); ``device`` is the device type the fit runs on
    ("cuda" or "cpu"), which picks the backend.  Nothing to do without a
    coordinator address for one process; with an address, one process
    forms a group of one (its collectives then run as for many)."""
    env = os.environ
    address = coordinator_address or env.get("DEGNORM_TPU_COORDINATOR")
    if num_processes is None:
        num_processes = int(env.get("DEGNORM_TPU_NUM_PROCESSES", "0"))
    if process_id is None:
        process_id = int(env.get("DEGNORM_TPU_PROCESS_ID", "-1"))
    init_method = f"tcp://{address}"
    if (not address and num_processes <= 0
            and all(k in env for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"))):
        # torchrun: its agent already serves the rendezvous store there
        address, init_method = env["MASTER_ADDR"], "env://"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
    if not address and num_processes <= 1:
        return
    if num_processes == 1 and process_id < 0:
        process_id = 0
    if not address or not 0 <= process_id < num_processes:
        raise ValueError(
            f"multihost: {num_processes} processes need a coordinator "
            "address and a process id in [0, n) (DEGNORM_TPU_COORDINATOR, "
            "DEGNORM_TPU_PROCESS_ID)")
    on_cuda = torch.device(device).type == "cuda"
    backend = env.get(BACKEND_ENV) or ("nccl" if on_cuda else "gloo")
    if on_cuda:
        torch.cuda.set_device(_local_cuda_index(process_id))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    log.info("torch.distributed initialized: process %d / %d, backend %s",
             process_index(), process_count(), backend)


def shutdown() -> None:
    """Leave the process group, where this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _local_cuda_index(rank: int) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if not torch.cuda.is_available():
        raise RuntimeError("multihost: no CUDA device is visible; pass "
                           "--device cpu to run on the CPU")
    return rank % torch.cuda.device_count()


def process_device(device: str = "cuda") -> torch.device:
    """The device this process drives: its card by the rank rule of the
    module docstring, or the CPU."""
    if torch.device(device).type != "cuda":
        return torch.device(device)
    return torch.device("cuda", _local_cuda_index(process_index()))


def global_mesh(device: str = "cuda") -> GeneMesh:
    """The gene mesh of the job: one shard a process, on its device."""
    return GeneMesh((process_device(device),), process_index(),
                    process_count())


def _comm_device() -> torch.device:
    """Where a collective's tensors must lie: the CPU under gloo, this
    process's card under NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_string(s: str, max_len: int = 1024) -> str:
    """Process 0's ``s`` on every process (the reference broadcasts its
    output directory so, ``__main_mpi__.py:62-71``).  A collective: every
    process calls it.  Raises when ``s`` is longer than ``max_len`` bytes
    in UTF-8."""
    data = s.encode("utf-8")
    if len(data) > max_len:
        raise ValueError(f"string longer than {max_len} bytes")
    if not dist.is_initialized():
        return s
    head = len(data).to_bytes(4, "little") + data
    buf = torch.zeros(max_len + 4, dtype=torch.uint8)
    buf[:len(head)] = torch.tensor(list(head), dtype=torch.uint8)
    buf = buf.to(_comm_device())
    dist.broadcast(buf, src=0)
    raw = bytes(buf.cpu().tolist())
    n = int.from_bytes(raw[:4], "little")
    return raw[4:4 + n].decode("utf-8")


def barrier(name: str = "degnorm") -> None:
    """Block until every process has reached this point (the reference's
    ``COMM.Barrier()``); nothing to do outside a process group."""
    if dist.is_initialized():
        log.debug("barrier %s", name)
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def gather_rows(local: torch.Tensor) -> torch.Tensor:
    """Every process's ``local`` rows, concatenated along dim 0 in process
    order, on every process (``local``'s row counts may differ from process
    to process; its other dimensions and its type may not).  Outside a
    process group: ``local`` itself.  Gloo gathers CPU tensors only, so
    under gloo a CUDA tensor is copied to the host, gathered there and
    copied back to its device."""
    if not dist.is_initialized():
        return local
    world = process_count()
    home = local.device
    t = local.to(_comm_device())
    is_bool = t.dtype == torch.bool
    if is_bool:
        t = t.to(torch.uint8)
    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    counts = [torch.zeros_like(n) for _ in range(world)]
    dist.all_gather(counts, n)
    counts = [int(c) for c in counts]
    padded = t.new_zeros((max(counts),) + tuple(t.shape[1:]))
    padded[:t.shape[0]] = t
    bufs = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(bufs, padded)
    out = torch.cat([b[:c] for b, c in zip(bufs, counts)])
    return (out.bool() if is_bool else out).to(home)


def gather_equal(local: torch.Tensor) -> torch.Tensor:
    """Every process's ``local``, stacked along a new dim 0 in process
    order, on every process: one all-gather, for tensors of the same shape
    and type on every process (the column shards' partials,
    parallel/seqpar.py; ``gather_rows`` takes rows of any count).  Outside
    a process group: ``local[None]``.  Under gloo a CUDA tensor goes
    through the host."""
    if not dist.is_initialized():
        return local[None]
    home = local.device
    t = local.to(_comm_device()).contiguous()
    bufs = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(bufs, t)
    return torch.stack(bufs).to(home)
