"""The process group of a multi-process run (torch.distributed), and the
mesh that spans its processes.

Port of blockmaze_tpu/parallel/distributed.py, which joins jax.distributed.
Every process starts the same program and initialize() joins the group,
one process per device. The arguments default from the variables a
launcher such as torchrun sets: MASTER_ADDR and MASTER_PORT (the
coordinator, host:port), WORLD_SIZE (the number of processes), RANK (this
process's id) and LOCAL_RANK (its index on its host; when it is unset the
processes exchange their hostnames through the rendezvous store and each
takes the number of lower ranks on its own host, local_indices); for
example, one process per card of a four-card host:

    torchrun --nproc-per-node 4 my_prover.py

or, by hand, on each of N processes:

    MASTER_ADDR=host0 MASTER_PORT=29500 WORLD_SIZE=N RANK=$RANK \\
        LOCAL_RANK=$LOCAL_RANK python my_prover.py

Each process drives one device, cuda:LOCAL_RANK by default, or the one
passed as device= (device="cpu" runs on the CPU; without a card and
without it, initialize raises); the processes
exchange their placement before the group exists, and the backend
follows from it: nccl when every process of a host has a card of its
own, gloo when processes share a card or run on the CPU (nccl refuses
two processes on one card). A failure of either is an error: nothing
falls back to the other. Under torchrun the group's store is the one its
agent already serves at MASTER_ADDR:MASTER_PORT, and every process joins
it as a client, as torch's own env:// rendezvous does.

global_mesh() is then the ProcessMesh of every process, one shard each
(parallel/mesh.py): Prover(dpk, mesh=global_mesh()) proves on every
process, each ending with the same proof. A single process skips
initialization, and its global_mesh() is its own cards (make_mesh).
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

from .mesh import ProcessMesh, make_mesh

# this process's device in the group, chosen by initialize()
_device = None


def _env_coordinator():
    host = os.environ.get("MASTER_ADDR")
    return f"{host}:{os.environ.get('MASTER_PORT', '29500')}" if host \
        else None


def choose_backend(placement) -> str:
    """The backend for a group whose processes sit at `placement`, one
    "host device" string per process: nccl when every process has a card
    and no two of one host share one, else gloo."""
    cuda = all(p.split()[1].startswith("cuda") for p in placement)
    return "nccl" if cuda and len(set(placement)) == len(placement) \
        else "gloo"


def local_indices(hosts) -> list:
    """Each process's index on its host, from every process's hostname in
    rank order: the number of lower ranks on the same host (["a", "a",
    "b", "b"] -> [0, 1, 0, 1])."""
    seen = {}
    out = []
    for h in hosts:
        out.append(seen.get(h, 0))
        seen[h] = out[-1] + 1
    return out


def _exchange(store, key: str, value: str, num_processes: int,
              process_id: int) -> list:
    """Every process's `value` in rank order, through the store under the
    prefix `key`."""
    view = dist.PrefixStore(key, store)
    view.set(str(process_id), value)
    keys = [str(r) for r in range(num_processes)]
    view.wait(keys)
    return [view.get(k).decode() for k in keys]


def _store(host: str, port: int, num_processes: int, process_id: int):
    """The group's key-value store: torchrun's agent's (a client of it,
    under this launch attempt's prefix) when its workers are told to use
    it, else one that process 0 serves at host:port."""
    if os.environ.get("TORCHELASTIC_USE_AGENT_STORE") == "True":
        attempt = os.environ.get("TORCHELASTIC_RESTART_COUNT", "0")
        return dist.PrefixStore(
            f"/worker/attempt_{attempt}",
            dist.TCPStore(host, port, num_processes, is_master=False))
    return dist.TCPStore(host, port, num_processes,
                         is_master=process_id == 0)


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device=None) -> bool:
    """Join the process group at coordinator ("host:port") on `device`
    (default cuda:<local index>: LOCAL_RANK, or local_indices of every
    process's hostname when it is unset; "cpu" only when passed), with
    the backend choose_backend picks from every process's placement.
    Raises when no card is visible and device is not "cpu". Returns True
    when a multi-process group was joined (or had been), False for the
    single-process no-op."""
    global _device
    coordinator = coordinator or _env_coordinator()
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if num_processes <= 1 or coordinator is None:
        return False
    if dist.is_initialized():
        return True
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("distributed.initialize: no CUDA device is "
                           "visible; pass device=\"cpu\" to join on the CPU")
    host, port = coordinator.rsplit(":", 1)
    store = _store(host, int(port), num_processes, process_id)
    if device.type == "cuda" and device.index is None:
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            hosts = _exchange(store, "host", socket.gethostname(),
                              num_processes, process_id)
            local = local_indices(hosts)[process_id]
        device = torch.device("cuda", int(local))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    placement = _exchange(store, "placement",
                          f"{socket.gethostname()} {device}", num_processes,
                          process_id)
    dist.init_process_group(choose_backend(placement),
                            store=store, world_size=num_processes,
                            rank=process_id)
    _device = device
    return True


def global_mesh(axis: str = "pts"):
    """The ProcessMesh of every process once initialize() has joined a
    group of more than one; else the mesh over every card this process
    sees."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        if _device is None:
            raise RuntimeError("the process group was joined without "
                               "initialize(), so no device was chosen")
        return ProcessMesh(_device, axis)
    return make_mesh(axis=axis)
