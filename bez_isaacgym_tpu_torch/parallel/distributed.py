"""Process-group set-up (port of `bez_isaacgym_tpu/parallel/distributed.py`;
the reference's Horovod rank plumbing, rlgames_utils.py:71-81).

One process per rank, each stepping its shard of the envs.  Under
`torchrun` the ranks read RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT
(and LOCAL_RANK / LOCAL_WORLD_SIZE) from the environment; a caller can
instead pass the JAX names (coordinator address, process count and id).
`spawn_ranks` starts N ranks on this host the way `torchrun` would, with
the `spawn` start method, for the harness and the tests.

The backend is chosen from the layout, never by trying one and falling
back to the other:

- `nccl` when every rank on a host has a card of its own;
- `gloo` when ranks share a card (NCCL refuses two ranks on one device:
  "Duplicate GPU detected");
- `gloo` on the CPU.

gloo implements `all_reduce` and `broadcast` for CUDA tensors but not
`all_gather`, so the port gathers nothing with `all_gather`:
`parallel/mesh.py::gather_env` sums a zero-padded buffer instead.
"""

from __future__ import annotations

import datetime
import os
import socket
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

# A collective that waits this long for another rank raises.
TIMEOUT = datetime.timedelta(minutes=10)


def under_torchrun() -> bool:
    """True when the environment describes more than one rank."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def local_layout() -> tuple[int, int]:
    """(local_rank, local_world_size) of this process on its host."""
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    return (int(os.environ.get("LOCAL_RANK", str(rank))),
            int(os.environ.get("LOCAL_WORLD_SIZE", str(world))))


def choose_backend(device_type: str, local_world_size: int,
                   n_cards: int) -> str:
    """The process group's backend for this layout: nccl when each of the
    host's ranks has a card of its own, gloo when ranks share one, gloo on
    the CPU."""
    if device_type == "cpu":
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r}")
    if n_cards < 1:
        raise RuntimeError("a CUDA process group needs a visible card")
    return "nccl" if local_world_size <= n_cards else "gloo"


def rank_device(device="cuda") -> torch.device:
    """This rank's device: `cuda:{local_rank % device_count}` on a card
    (ranks beyond the host's cards share them), the CPU otherwise."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    local_rank, _ = local_layout()
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def summary() -> dict:
    """The JAX summary's keys.  A rank computes on one device, so
    `local_devices` is 1 and `global_devices` is the number of ranks: the
    size of the env axis the batch is sharded over."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return {"process_index": dist.get_rank() if dist.is_initialized() else 0,
            "process_count": n, "local_devices": 1, "global_devices": n}


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device="cuda") -> dict:
    """`torch.distributed.init_process_group` for this layout; returns the
    summary dict (process index/count, local/global devices).

    With nothing to coordinate (one process, no `torchrun`) it is a no-op,
    as the JAX function is, and so it is when the group already exists.
    `coordinator_address` is "host:port"; without it the environment's
    MASTER_ADDR / MASTER_PORT are read.
    """
    if dist.is_initialized():
        return summary()
    world = num_processes if num_processes is not None else \
        int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return summary()
    rank = process_id if process_id is not None else \
        int(os.environ["RANK"])
    if coordinator_address is None:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    os.environ.setdefault("LOCAL_WORLD_SIZE", str(world))
    os.environ.setdefault("LOCAL_RANK", str(rank))
    dev = torch.device(device)
    _, local_world = local_layout()
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = choose_backend(dev.type, local_world, n_cards)
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device(dev))
    print(f"init_distributed: rank {rank} of {world}, backend {backend} "
          f"({local_world} ranks on this host, {n_cards} cards), device "
          f"{rank_device(dev)}", flush=True)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=world, rank=rank,
        timeout=TIMEOUT)
    return summary()


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn, n_ranks: int, port: int, out_dir: str,
               args: tuple) -> None:
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(n_ranks),
                       "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(n_ranks),
                       "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)})
    try:
        result = fn(rank, *args)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, n_ranks: int, *args) -> list:
    """Run `fn(rank, *args)` in `n_ranks` spawned processes on this host,
    with the environment `torchrun --nproc-per-node n_ranks` gives each
    (a free localhost port); `fn` calls `init_distributed` (or builds a
    `Runner`) itself.  Returns each rank's return value (saved with
    torch.save: keep it on the CPU).  A rank that raises fails the call and
    the other ranks are terminated; every process is joined."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="bez_ranks_") as out_dir:
        mp.start_processes(_rank_main, args=(fn, n_ranks, free_port(),
                                             out_dir, args),
                           nprocs=n_ranks, join=True, start_method="spawn")
        return [torch.load(Path(out_dir) / f"rank{r}.pt", weights_only=False)
                for r in range(n_ranks)]
