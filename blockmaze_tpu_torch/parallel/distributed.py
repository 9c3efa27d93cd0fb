"""The process group of a multi-process run (torch.distributed).

Port of blockmaze_tpu/parallel/distributed.py, which joins jax.distributed.
Every process starts the same program and initialize() joins the group:
the nccl backend when the process sees a card, gloo on the CPU. The
arguments default from the variables a launcher such as torchrun sets:
MASTER_ADDR and MASTER_PORT (the coordinator, host:port), WORLD_SIZE (the
number of processes) and RANK (this process's id); for example

    MASTER_ADDR=host0 MASTER_PORT=29500 WORLD_SIZE=2 RANK=$RANK \\
        python my_prover.py

A single process skips initialization. The mesh of a Prover is this
process's cards (global_mesh); a mesh that spans processes is not ported
yet.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .mesh import make_mesh


def _env_coordinator():
    host = os.environ.get("MASTER_ADDR")
    return f"{host}:{os.environ.get('MASTER_PORT', '29500')}" if host \
        else None


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Join the process group at coordinator ("host:port"). Returns True
    when a multi-process group was joined (or had been), False for the
    single-process no-op."""
    coordinator = coordinator or _env_coordinator()
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if num_processes <= 1 or coordinator is None:
        return False
    if dist.is_initialized():
        return True
    dist.init_process_group(
        "nccl" if torch.cuda.is_available() else "gloo",
        init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id)
    return True


def global_mesh(axis: str = "pts"):
    """The mesh over every card this process sees."""
    return make_mesh(axis=axis)
