"""Joining a group of ranks — the port of ``wav2letter_tpu/parallel/
distributed.py`` and of the joining step of the JAX ``Config.
apply_runtime_flags`` (the reference's ``fl::initDistributed``,
``cpc/Train.cpp:342-353``).

Rendezvous is ``env://``: the variables ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) stand where
the JAX package reads ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
``JAX_PROCESS_ID``; ``--world_rank`` applies where ``RANK`` is unset. One rank
drives one device. The backend follows the device: NCCL for the card, gloo
for the CPU (:func:`backend_for`).

One deliberate difference: where ``jax.distributed.initialize`` fails, the
JAX package logs a warning and trains on in one process. The port raises. A
run that asked for several ranks and got one would train on its share of the
data and report it as the whole.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

# Every group gets a timeout, so that a rank that dies fails the others'
# collectives instead of leaving them waiting.
GROUP_TIMEOUT = timedelta(minutes=10)


def backend_for(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_rank() -> int:
    """The rank's device index on its node (``LOCAL_RANK``, 0 without it)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def init_distributed(backend: str, world_rank: Optional[int] = None,
                     num_ranks: Optional[int] = None,
                     timeout: timedelta = GROUP_TIMEOUT) -> dict:
    """Join the process group through ``env://`` unless one is already
    initialized (then that group is used as it is). Returns the topology
    under the JAX function's keys, with ranks for processes and one device a
    rank."""
    if not dist.is_initialized():
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"--enable_distributed: {', '.join(missing)} not set; launch with "
                "torchrun, or set RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT")
        rank = int(os.environ["RANK"]) if "RANK" in os.environ else int(world_rank or 0)
        world = int(os.environ.get("WORLD_SIZE", num_ranks or 1))
        if num_ranks and num_ranks != world:
            raise ValueError(f"--world_size={num_ranks} but WORLD_SIZE={world}")
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world, timeout=timeout)
    n = dist.get_world_size()
    return {"process_index": dist.get_rank(), "process_count": n,
            "local_devices": 1, "global_devices": n}
