"""Process groups, meshes and failure detection of the sharded paths:
`srsran_ce_tpu/parallel/mesh.py` on `torch.distributed`.

The mesh axes are the JAX package's:

  dp  data parallel over independent (cell, UE, port, slot) problems;
  sp  subcarrier parallel over the frequency axis of one wideband problem,
      with overlap-save halo exchanges (parallel/subcarrier.py).

Where JAX runs one program over a device mesh, the port runs one process a
rank (SPMD): each rank holds its own slice of the inputs and outputs, and the
only cross-rank traffic is the collective layer's (`parallel/comm.py`).
`make_mesh` builds a `torch.distributed.device_mesh.DeviceMesh`; `comm(mesh,
axis)` is an axis' collectives, over the group `mesh.get_group(axis)`.
"""
from __future__ import annotations

import datetime
import os
import threading
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .comm import Comm


def multihost_initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Join the process group; True when more than one process is (now) in it.

    `coordinator_address` ("host:port") with `num_processes` and `process_id`
    rendezvous over TCP; without them the torchrun environment (MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE) is read, and with neither the call returns
    False (single-process operation), as the JAX function does without a
    cluster. The backend is NCCL when a card is present, gloo otherwise.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        if backend == "nccl":
            torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id))
    elif all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")):
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
                                  % torch.cuda.device_count())
        dist.init_process_group(backend, init_method="env://")
    else:
        return False
    return dist.get_world_size() > 1


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("dp", "sp"),
    device_type: Optional[str] = None,
):
    """A DeviceMesh over the world's ranks, row-major in rank order.

    Default: every rank on `axis_names[0]` (the others 1). `device_type`
    defaults to "cuda" on an NCCL world and "cpu" otherwise (a gloo world may
    compute on the card: the mesh only names the groups)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n or len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} over axes {tuple(axis_names)} != {n} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names))


def comm(mesh, axis: str) -> Comm:
    """The collectives of mesh axis `axis`, as seen from this rank."""
    return Comm(mesh.get_group(axis), axis)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(list(mesh.mesh_dim_names).index(axis))


def batch_slice(x, mesh, axis: str = "dp"):
    """This rank's rows of a global (B, ...) batch over mesh axis `axis` (the
    counterpart of the JAX `batch_sharding`): rows [r B/n, (r+1) B/n)."""
    n, r = axis_size(mesh, axis), mesh.get_local_rank(axis)
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} is not divisible by |{axis}| = {n}")
    m = x.shape[0] // n
    return x[r * m : (r + 1) * m]


def gather_batch(result, mesh, axis: str = "dp"):
    """The global result of rank-local results (batch axis first) over mesh
    axis `axis`: every tensor of a result (dataclass, tuple) all_gathered
    along dim 0, in rank order."""
    from ..graphs import map_tensors

    c = comm(mesh, axis)
    return map_tensors(lambda t: c.all_gather(t, 0), result)


# ---------------------------------------------------------------------------
# Failure detection: a coarse fail-fast for long-running jobs
# ---------------------------------------------------------------------------


def _barrier_device(group) -> torch.device:
    if str(dist.get_backend(group)) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_device_barrier(group=None, timeout_s: float = 300.0) -> float:
    """One sum over every rank of `group` (the world by default); returns the
    elapsed seconds. Each rank contributes rank+1, so the sum n(n+1)/2 shows
    that every rank took part (a wedged rank hangs the sum instead, until
    `timeout_s`)."""
    t0 = time.time()
    n, r = dist.get_world_size(group), dist.get_rank(group)
    x = torch.tensor([float(r + 1), 0.0], device=_barrier_device(group))
    dist.all_reduce(x, group=group, async_op=True).wait(datetime.timedelta(seconds=timeout_s))
    got = float(x[0])
    if got != n * (n + 1) / 2:
        raise RuntimeError(f"device barrier mismatch: sum {got} != {n * (n + 1) / 2}")
    return time.time() - t0


class Heartbeat:
    """Background watchdog: a barrier every `interval_s` on a gloo group of its
    own (a thread issuing collectives on the group the main thread uses would
    interleave with them). A round that raises or exceeds `timeout_s` marks
    the heartbeat unhealthy and calls `on_failure` (default: log loudly).

    Every rank of `ranks` (the world by default) must construct it, start it
    and stop it: the rounds carry a stop vote, so all ranks leave after the
    same round.

        hb = Heartbeat(interval_s=30).start()
        ... long serving loop, checking hb.healthy ...
        hb.stop()
    """

    def __init__(self, interval_s: float = 30.0, timeout_s: float = 120.0, on_failure=None,
                 ranks=None):
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.on_failure = on_failure
        self.healthy = True
        self.last_latency_s: Optional[float] = None
        self.error: Optional[str] = None
        self.rounds = 0
        self._group = dist.new_group(ranks=ranks, backend="gloo",
                                     timeout=datetime.timedelta(seconds=self.timeout_s))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _fail(self, msg: str) -> None:
        self.healthy = False
        self.error = msg
        if self.on_failure is not None:
            self.on_failure(msg)
        else:  # pragma: no cover - side-effect logging
            import sys

            print(f"[heartbeat] DEVICE FAILURE: {msg}", file=sys.stderr, flush=True)

    def _round(self) -> bool:
        """One barrier with this rank's stop vote; True when any rank voted."""
        t0 = time.time()
        n, r = dist.get_world_size(self._group), dist.get_rank(self._group)
        x = torch.tensor([float(r + 1), float(self._stop.is_set())])
        dist.all_reduce(x, group=self._group)
        dt = time.time() - t0
        if float(x[0]) != n * (n + 1) / 2:
            raise RuntimeError(f"heartbeat barrier mismatch: sum {float(x[0])} != {n * (n + 1) / 2}")
        self.last_latency_s = dt
        self.rounds += 1
        if dt > self.timeout_s:
            raise TimeoutError(f"barrier took {dt:.1f}s (> {self.timeout_s}s)")
        return float(x[1]) > 0

    def _run(self) -> None:
        while True:
            self._stop.wait(self.interval_s)
            try:
                if self._round():
                    return
            except Exception as e:  # noqa: BLE001 - any collective error is a failure
                self._fail(f"{type(e).__name__}: {e}")
                return

    def start(self) -> "Heartbeat":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=self.timeout_s + 5.0)
