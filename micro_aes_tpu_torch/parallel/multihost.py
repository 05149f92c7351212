"""Multi-host orchestration: the process group, the global mesh and the
host-local batch.

The JAX package runs jax.distributed and a global (dp, sp) mesh over every
device of every host.  Here each process is one rank with one device; the
world comes from init_process_group (arguments, or the env:// variables a
launcher such as torchrun sets), and the only cross-rank traffic of the
sharded engines is the XOR all-reduce of the sp-sharded GCM tag.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ._dist import PG_TIMEOUT, backend_for
from .mesh import Mesh, make_mesh

_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *, device="cuda") -> None:
    """init_process_group from the arguments (coordinator "host:port",
    the world size and this process's rank) or, without a coordinator, from
    the env:// variables.  No-op when a process group already exists, or in
    a solo process with no cluster environment (every path then works on
    the solo mesh), as the JAX package's init_distributed does.  The
    backend follows `device` (NCCL on CUDA, gloo on the CPU), and the group
    gets the finite PG_TIMEOUT."""
    if dist.is_initialized():
        return
    if coordinator is None and not all(v in os.environ for v in _ENV):
        if num_processes in (None, 1):
            return
        raise ValueError("init_distributed: a multi-process world needs a coordinator "
                         "address or the env:// variables")
    init = f"tcp://{coordinator}" if coordinator is not None else "env://"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend_for(device), init_method=init, timeout=PG_TIMEOUT,
                            **kwargs)


def global_mesh(dp: int | None = None, sp: int | None = None, *, device="cuda") -> Mesh:
    """(dp, sp) mesh over every rank of the world.  Defaults: sp = the
    ranks per host (LOCAL_WORLD_SIZE, as a launcher sets it; 1 without
    one), dp = the number of hosts: the layout that keeps the tag's
    all-reduce inside a host."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp is None or sp is None:
        sp = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        dp = world // sp
    return make_mesh(dp, sp, device=device)


def host_local_batch(mesh: Mesh, arrays) -> torch.Tensor:
    """This rank's slice of the dp axis of a batch, as a tensor on the
    mesh's device.  torch has no global array: where the JAX package
    assembles one from each host's local data, each rank here keeps only
    its own rows, [dp_idx * B/dp, (dp_idx + 1) * B/dp) of `arrays` (the
    batch's leading axis, B a multiple of dp)."""
    arr = np.asarray(arrays)
    dp = mesh.shape["dp"]
    if arr.shape[0] % dp:
        raise ValueError(f"host_local_batch: batch of {arr.shape[0]} does not split over dp={dp}")
    rows = arr.shape[0] // dp
    part = np.ascontiguousarray(arr[mesh.dp_idx * rows:(mesh.dp_idx + 1) * rows])
    if part.dtype == np.uint32:  # torch keeps stream words as int32 (same bits)
        part = part.view(np.int32)
    return torch.from_numpy(part).to(mesh.device)
