"""Spawn a world of ranks on one machine: the sharded paths' tests, the deep
fuzz's sharded sweep, `entry.dryrun_multichip` and chip_smoke run through it.

    results = spawn_world(fn, n, backend="gloo", device="cpu", args=(...))

starts n processes with the `spawn` method (torch.multiprocessing), joins each
to one process group (`backend`) through a `FileStore` in a fresh temporary
directory (no port is opened, so worlds started side by side never meet),
calls `fn(*args)` on every rank and returns the ranks' return values in rank
order. `fn` is looked up by its import path in each child, so it lives in
this package: a child imports no JAX and no test module. Rank r computes on
`device` ("cuda" means cuda:r modulo the card count; every rank of a gloo
world on a one-card machine shares cuda:0). A rank that raises ends the
world with the child's traceback; a collective that hangs is cut by the
group's timeout.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile

import torch


def rank_device(device, rank: int) -> torch.device:
    """The device rank `rank` computes on for a world asked to run on `device`."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def init_rank(rank: int, n: int, backend: str, device, store_path: str,
              timeout_s: float = 600.0) -> torch.device:
    """Join rank `rank` of an n-rank world rendezvousing at `store_path`; returns
    the rank's device (made current when it is a card)."""
    import torch.distributed as dist

    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, n)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def _child(rank: int, fn, n: int, backend: str, device, tmp: str, args, timeout_s: float):
    import torch.distributed as dist

    # the machine's cores shared out between the ranks (each would take them all)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    init_rank(rank, n, backend, device, os.path.join(tmp, "store"), timeout_s)
    try:
        out = fn(*args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_world(fn, n: int, backend: str = "gloo", device="cpu", args=(),
                timeout_s: float = 600.0) -> list:
    """`fn(*args)` on each rank of a spawned n-rank world; the ranks' results.
    `timeout_s` bounds each collective (the process group's timeout)."""
    import torch.multiprocessing as mp

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("spawn_world(device='cuda'): no CUDA device here")
    with tempfile.TemporaryDirectory(prefix="srsce_world_") as tmp:
        mp.start_processes(_child, args=(fn, n, backend, str(device), tmp, tuple(args), timeout_s),
                           nprocs=n, join=True, start_method="spawn")
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
