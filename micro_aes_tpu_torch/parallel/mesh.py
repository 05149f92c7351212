"""The (dp, sp) grid of ranks the sharded engines run on.

The JAX package's mesh is a 2-D array of devices with the axes "dp"
(independent messages) and "sp" (the block axis within a message).  Here
each rank of a torch.distributed world holds one device, and rank r sits
at grid coordinates (r // sp, r % sp).  A rank's sp group is its row of the
grid (the ranks that share a message), its dp group its column.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ._dist import PG_TIMEOUT


@dataclass(frozen=True)
class Mesh:
    """shape {"dp": dp, "sp": sp} (read as in JAX: mesh.shape["sp"]);
    coords this rank's (dp_idx, sp_idx), None for a rank outside the grid;
    sp_group / dp_group its row and column of the grid (None in a solo
    process, where no process group exists); device the rank's device."""
    shape: dict
    coords: tuple[int, int] | None
    sp_group: object
    dp_group: object
    device: torch.device

    @property
    def dp_idx(self) -> int:
        return self._coords()[0]

    @property
    def sp_idx(self) -> int:
        return self._coords()[1]

    def _coords(self) -> tuple[int, int]:
        if self.coords is None:
            raise ValueError("this rank lies outside the mesh")
        return self.coords


def rank_device(device="cuda") -> torch.device:
    """The device of this rank: cuda:(local rank % device count) on CUDA
    (the local rank from LOCAL_RANK, else the global rank), the CPU as
    given."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(dp: int, sp: int, *, device="cuda") -> Mesh:
    """(dp, sp) mesh over the first dp*sp ranks of the world: 'dp' =
    independent messages (data parallel), 'sp' = the block axis within a
    message.  Every rank of the world must call it with the same arguments
    (each creates every subgroup, in the same order, as new_group
    requires); ranks past dp*sp get no coordinates.  The subgroups get the
    finite PG_TIMEOUT.  With no process group initialised, make_mesh(1, 1)
    is a solo mesh whose collectives are skipped."""
    if dp < 1 or sp < 1:
        raise ValueError(f"mesh axes must be positive, got dp={dp}, sp={sp}")
    dev = rank_device(device)
    if not dist.is_initialized():
        if dp * sp > 1:
            raise ValueError(f"need {dp * sp} devices, have 1")
        return Mesh({"dp": 1, "sp": 1}, (0, 0), None, None, dev)
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp * sp > world:
        raise ValueError(f"need {dp * sp} devices, have {world}")
    sp_groups = [dist.new_group([d * sp + j for j in range(sp)], timeout=PG_TIMEOUT)
                 for d in range(dp)]
    dp_groups = [dist.new_group([d * sp + j for d in range(dp)], timeout=PG_TIMEOUT)
                 for j in range(sp)]
    if rank >= dp * sp:
        return Mesh({"dp": dp, "sp": sp}, None, None, None, dev)
    d, j = divmod(rank, sp)
    return Mesh({"dp": dp, "sp": sp}, (d, j), sp_groups[d], dp_groups[j], dev)
