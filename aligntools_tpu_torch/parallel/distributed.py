"""Multi-process execution: initialization, result gather, failure handling.

Port of ``aligntools_tpu/parallel/distributed.py`` onto
``torch.distributed``:

  * ``init_multihost()`` starts the process group from the environment
    ``torchrun`` sets (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE,
    LOCAL_RANK): NCCL bound to this rank's card, or gloo when the caller
    asks for the CPU, with a timeout, and a barrier so that every rank
    either enters the run or the whole job aborts together;
  * ``gather_to_host0`` gathers per-rank result arrays so that rank 0 owns
    all printing (the stdout contract stays the single process's);
  * ``abort_all`` tears the whole job down after a local failure: it
    prints ``FATAL ERROR (rank r): ...``, destroys the group and exits
    non-zero, so that no rank is left hung in a collective.

With a world of one (no ``WORLD_SIZE > 1`` and no group of more than one
rank) all of them do nothing, so every call site can use them
unconditionally.
"""

from __future__ import annotations

import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300


def world() -> int:
    """The ranks of the initialized group, else WORLD_SIZE (1 unset)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def is_multihost() -> bool:
    return world() > 1


def local_device(device) -> torch.device:
    """This rank's device: a CUDA device without an index takes
    LOCAL_RANK's card (modulo the visible cards); an index, or the CPU,
    is taken as it is."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        return torch.device("cuda", local % max(1, torch.cuda.device_count()))
    return device


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_multihost(timeout_s: int = DEFAULT_TIMEOUT_S, *, device="cuda",
                   backend: str | None = None) -> None:
    """Start the process group from torchrun's environment (nothing
    without ``WORLD_SIZE > 1`` or when a group exists). ``backend``
    defaults to NCCL on a CUDA ``device`` (bound to LOCAL_RANK's card) and
    gloo on the CPU; a failed or partial start raises on every rank within
    ``timeout_s`` rather than hanging."""
    if not is_multihost() or dist.is_initialized():
        return
    device = local_device(device)
    backend = backend or default_backend(device)
    kwargs = {}
    if backend == "nccl":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(
        backend, timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    barrier("aligntools-init")


def barrier(name: str = "") -> None:
    """All-rank barrier (nothing at a world of one). ``name`` labels the
    call site, as the JAX barrier's does."""
    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _collective_device():
    return (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))


def gather_to_host0(local_values: np.ndarray) -> np.ndarray | None:
    """Every rank's (k, ...) array, concatenated on rank 0 (None on the
    others); every rank calls it, with the same shape and dtype. At a
    world of one, the array itself."""
    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return local_values
    dev = _collective_device()
    x = torch.from_numpy(np.ascontiguousarray(local_values)).to(dev)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    if dist.get_rank() != 0:
        return None
    return torch.cat(parts).cpu().numpy().reshape(-1, *local_values.shape[1:])


def abort_all(err: BaseException) -> None:
    """Tear the whole job down after a local failure: ``FATAL ERROR (rank
    r): ...`` on stderr, the group destroyed (the other ranks' pending
    collectives fail rather than hang), exit status 1."""
    sys.stderr.write(f"FATAL ERROR (rank {rank()}): {err}\n")
    sys.stderr.flush()
    if dist.is_available() and dist.is_initialized():
        try:
            dist.destroy_process_group()
        finally:
            sys.exit(1)
    sys.exit(1)
