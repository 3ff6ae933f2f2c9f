"""Process-group bootstrap and meshes.

Port of ``pytextgcn_tpu/parallel/multihost.py``. One process per rank,
joined by ``torch.distributed``:

* under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` set) every rank joins
  through ``env://``;
* with an explicit coordinator (``host:port``, the number of processes and
  this one's id) the ranks join over TCP; a cluster asked for that fails to
  form raises;
* with neither, this process runs alone, as a group of one.

The backend is NCCL when each rank has its own card and gloo on the CPU.
Ranks that share one card must ask for it (``backend="gloo"`` with a CUDA
device): that mode is never chosen silently.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional, Union

import torch
import torch.distributed as dist

from .sharded import Mesh, _rank_device, make_mesh

_init_done = False


def default_backend(device: Optional[Union[str, torch.device]] = None) -> str:
    """NCCL for a CUDA device (None means the GPU where there is one),
    gloo for the CPU."""
    if device is None:
        return "nccl" if torch.cuda.is_available() else "gloo"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device: Optional[Union[str, torch.device]] = None,
                     timeout_s: Optional[float] = None) -> None:
    """Join the process group (idempotent).

    ``coordinator_address``: ``host:port`` of rank 0 (or a full
    ``tcp://`` URL), with ``num_processes`` and this process's
    ``process_id``; None uses ``env://`` under torchrun, else a group of
    one. ``backend``: None picks :func:`default_backend` of ``device``.
    ``timeout_s``: how long to wait for the other ranks (torch's default
    when None)."""
    global _init_done
    if dist.is_initialized():
        _init_done = True
        return
    backend = backend or default_backend(device)
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator needs num_processes and process_id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        # an explicitly requested cluster that fails to form (wrong address,
        # dead coordinator) is a real failure: it raises, nothing is latched
        dist.init_process_group(backend, init_method=url, world_size=num_processes,
                                rank=process_id, **kw)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        # no cluster environment: this process alone
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kw)
    _init_done = True


def global_mesh(axis: str = "graph", device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """The mesh over every rank of every host (the row partition is
    oblivious to host boundaries)."""
    return make_mesh(None, axis=axis, device=device)


def host_local_mesh(axis: str = "graph",
                    device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """The mesh over this host's ranks only (for per-host ensembles). Every
    rank creates every host's group, in the same order, as
    ``dist.new_group`` requires."""
    if not dist.is_initialized():
        init_distributed(device=device)
    world, rank = dist.get_world_size(), dist.get_rank()
    dev = _rank_device(device, dist.get_backend(), rank)  # NCCL's object gather needs it set
    hosts = [None] * world
    dist.all_gather_object(hosts, socket.gethostname())
    mine = None
    for host in sorted(set(hosts)):
        ranks = tuple(r for r, h in enumerate(hosts) if h == host)
        group = dist.new_group(list(ranks))
        if host == hosts[rank]:
            mine = group, ranks
    group, ranks = mine
    return Mesh(group=group, rank=ranks.index(rank), world_size=len(ranks), device=dev,
                backend=dist.get_backend(group), axis=axis, ranks=ranks)
