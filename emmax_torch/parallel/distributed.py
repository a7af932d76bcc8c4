"""Process-group start-up, port of ``emmax_tpu/parallel/distributed.py``.

One process drives one device. ``initialize_distributed`` joins the
default ``torch.distributed`` process group from torchrun's environment
(``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` /
``LOCAL_RANK``), or from the JAX package's spelling of it
(``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``), or from
its arguments. The backend is NCCL on "cuda" and gloo on "cpu": without a
card a "cuda" start raises rather than run on gloo. Called when nothing
asks for a group (no arguments, no such variables), it does nothing and
returns rank 0.
"""

from __future__ import annotations

import os
from typing import Optional

from emmax_torch.overwatch import initialize_overwatch

overwatch = initialize_overwatch(__name__)


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device_type: str = "cuda") -> int:
    """Join the default process group (``host:port`` rendezvous) and
    return this process's rank; on "cuda" the process's device becomes
    ``LOCAL_RANK`` (else the rank modulo the visible cards)."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank()
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if addr is None and os.environ.get("MASTER_ADDR"):
        addr = (f"{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
    world = num_processes or _env_int("WORLD_SIZE", "NUM_PROCESSES")
    if addr is None and world is None:
        return 0
    if addr is None or world is None:
        raise ValueError("a process group needs both a coordinator address "
                         f"and a process count (got {addr!r}, {world!r})")
    rank = (process_id if process_id is not None
            else _env_int("RANK", "PROCESS_ID") or 0)
    kw = {}
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_type='cuda' needs a CUDA device; "
                               "pass device_type='cpu' for gloo")
        local = _env_int("LOCAL_RANK")
        local = rank % torch.cuda.device_count() if local is None else local
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=world, rank=rank, **kw)
    overwatch.info(f"process {rank}/{world} on {backend}", all_ranks=True)
    return rank


def barrier(name: str = "barrier") -> None:
    """Every rank waits here for the others (the reference's
    ``dist.barrier()`` around checkpoints); nothing without a group."""
    import torch.distributed as dist

    if dist.is_initialized():
        overwatch.debug(f"barrier {name}")
        dist.barrier()
