"""One rank a card: start or join the process group a run spans.

The reference needs no such module: JAX drives every chip of the host
from one controller. The port runs SPMD, one process a card
(`distributed.sharding`), so an entry point that should use every card
of the host runs its work through `launch`:

  * under `torchrun` (its variables `RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
    `MASTER_ADDR` and `MASTER_PORT` set), this process joins the group
    (`init_method="env://"`) as its rank, on card `LOCAL_RANK`;
  * otherwise, on `cuda` with k >= 2 cards visible, it starts k ranks
    itself (`spawn`, over `torch.multiprocessing.spawn`) over a file store
    in a fresh temporary directory, each rank on its own card. A rank that
    raises fails the whole call: the other ranks are ended and the parent
    raises;
  * with one card, or on the CPU, it runs the work in this process with
    no group: the reference on a one-device host.

The backend is NCCL for `cuda` and gloo for `cpu`. Every collective of
the group times out after `TIMEOUT` (a rank that died leaves the others
waiting no longer), and the group is destroyed when the work returns.
"""
from __future__ import annotations

import datetime
import os
import tempfile
from pathlib import Path
from typing import Callable

import torch
import torch.distributed as dist

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")
# a collective waits this long at most: past the longest checkpoint write
# a writing rank makes the others wait for (an 84 GB state, minutes)
TIMEOUT = datetime.timedelta(minutes=30)


def under_torchrun() -> bool:
    return all(v in os.environ for v in TORCHRUN_VARS)


def backend_of(device: str) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def ranks_wanted(device: str) -> int:
    """The ranks `launch` starts itself: one a visible card on `cuda`,
    else 1 (one process, no group)."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return 1
    return torch.cuda.device_count()


def launch(fn: Callable, args: tuple = (), *, device: str = "cuda"):
    """Run `fn(*args)` on every rank (the module's docstring says which
    ranks), each inside its process group. Returns what `fn` returns in
    this process; with ranks started here, None (each rank ran `fn` in a
    process of its own)."""
    if under_torchrun():
        return _in_group(fn, args, device, init_method="env://",
                         rank=int(os.environ["RANK"]),
                         world=int(os.environ["WORLD_SIZE"]),
                         local=int(os.environ["LOCAL_RANK"]))
    world = ranks_wanted(device)
    if world < 2:
        return fn(*args)
    spawn(fn, args, world=world, device=device)
    return None


def spawn(fn: Callable, args: tuple, *, world: int, device: str) -> None:
    """Start `world` ranks, each running `fn(*args)` in its group (rank r
    on card r under `cuda`), over a file store in a fresh temporary
    directory; returns once every rank has. A rank that raises ends the
    others, and this raises (`torch.multiprocessing.ProcessRaisedException`
    or `ProcessExitedException`)."""
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        store = (Path(tmp) / "store").as_uri()
        torch.multiprocessing.spawn(_spawned, nprocs=world, join=True,
                                    args=(world, store, fn, args, device))


def _spawned(rank: int, world: int, store: str, fn, args,
             device: str) -> None:
    _in_group(fn, args, device, init_method=store, rank=rank, world=world,
              local=rank)


def _in_group(fn, args, device: str, *, init_method: str, rank: int,
              world: int, local: int):
    kw = {}
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend_of(device), init_method=init_method,
                            rank=rank, world_size=world, timeout=TIMEOUT,
                            **kw)
    try:
        return fn(*args)
    finally:
        dist.destroy_process_group()


def barrier() -> None:
    """Every rank of the default group waits here (on its own card under
    NCCL)."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def broadcast(value, src: int = 0):
    """`value` of rank `src` on every rank of the default group (any
    picklable value)."""
    box = [value]
    dist.broadcast_object_list(box, src=src)
    return box[0]
