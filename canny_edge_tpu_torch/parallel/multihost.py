"""Several processes: the process group, the global mesh, host-sharded
streaming and statistics summed over hosts.

The counterpart of ``canny_edge_tpu/parallel/multihost.py`` on
``torch.distributed``:

* :func:`initialize` joins the process group from arguments or from
  torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
  ``RANK``); a single process with none of them does nothing;
* :func:`global_mesh`: a ("data", "y", "x") mesh over every rank's blocks,
  the data axis rank-major, so batch sharding crosses processes;
* :func:`host_local_stream_config`: which frames of a stream this process
  feeds (round-robin, as ``StreamingRunner``'s ``host_id`` / ``num_hosts``);
* :func:`aggregate_stats`: ``StreamStats`` summed over the processes.

NCCL takes one card a rank; with ``device="cpu"`` the group is gloo.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from ..kernels.fused import resolve_device


def _dist():
    import torch.distributed as dist

    return dist


def _group_size() -> tuple[int, int]:
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device="cuda") -> tuple[int, int]:
    """Join the process group; returns ``(rank, world size)``.

    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` default to torchrun's ``MASTER_ADDR:MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``.  A single process with no coordinator
    skips it.  ``device``: "cuda" (NCCL, this rank's card is ``LOCAL_RANK``
    or the rank modulo the cards) or "cpu" (gloo).
    """
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        port = env.get("MASTER_PORT", "29500")
        coordinator_address = f"{env['MASTER_ADDR']}:{port}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes in (None, 1):
        return 0, 1
    dist = _dist()
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    device = resolve_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", (process_id or 0)
                            % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes or 1,
                            rank=process_id or 0)
    return dist.get_rank(), dist.get_world_size()


def global_mesh(data: int | None = None, y: int | None = None,
                x: int | None = None, devices=None):
    """Mesh over every rank's blocks (``devices``: this rank's, as
    :func:`.sharded.make_mesh` takes them), the data axis rank-major:
    with ``data = world * per-rank data`` batch sharding crosses processes
    and each rank's spatial blocks stay with it."""
    from .sharded import make_mesh

    if data is None:
        data = _group_size()[1]
    return make_mesh(devices, data=data, y=y, x=x)


@dataclass
class HostStreamConfig:
    host_id: int
    num_hosts: int
    batch_size: int


def host_local_stream_config(batch_size: int) -> HostStreamConfig:
    rank, world = _group_size()
    return HostStreamConfig(host_id=rank, num_hosts=world,
                            batch_size=batch_size)


def aggregate_stats(stats) -> dict:
    """Sum StreamStats over the processes (frames, batches, MP); the max of
    seconds."""
    rank, world = _group_size()
    if world == 1:
        return stats.to_dict()
    dist = _dist()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    summed = torch.tensor([stats.frames, stats.batches, stats.mp],
                          dtype=torch.float64, device=dev)
    dist.all_reduce(summed)
    secs = torch.tensor([stats.seconds], dtype=torch.float64, device=dev)
    dist.all_reduce(secs, op=dist.ReduceOp.MAX)
    frames, batches, mp = (float(v) for v in summed.cpu())
    secs = float(secs.item())
    return {
        "frames": int(frames), "batches": int(batches),
        "mp": mp, "seconds": secs,
        "fps": frames / secs if secs else 0.0,
        "mp_per_s": mp / secs if secs else 0.0,
        "hosts": world,
    }
