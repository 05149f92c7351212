"""The one place for what torch.distributed needs from the port: the
backend for a device, the process-group timeout, and the XOR all-reduce.

The JAX package's counterpart (_shmap.py) resolves a version difference of
shard_map in one place; here that place holds the choices every sharded
path shares:

  * `backend_for(device)`: NCCL on CUDA, gloo on the CPU;
  * `PG_TIMEOUT`: every process group and subgroup gets this finite
    timeout, so that a collective that hangs fails instead;
  * `xor_allreduce(bits, group)`: the XOR of 0/1 bit vectors across the
    ranks of `group`, as an all_reduce SUM of int32 followed by `& 1` (GF(2)
    addition is the parity of the integer sum).  A solo process (no process
    group) has nothing to reduce.
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

PG_TIMEOUT = datetime.timedelta(seconds=60)

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device) -> str:
    """The collective backend of a device: "nccl" for CUDA, "gloo" for the
    CPU; ValueError for any other device type."""
    kind = torch.device(device).type
    if kind not in _BACKENDS:
        raise ValueError(f"no collective backend for device {kind!r}")
    return _BACKENDS[kind]


def xor_allreduce(bits: torch.Tensor, group=None) -> torch.Tensor:
    """XOR of int 0/1 `bits` over the ranks of `group` -> int32 0/1 of the
    same shape.  Without a process group (a solo mesh) the group can only
    be this rank, and the call is skipped; otherwise the all_reduce runs,
    and raises if it fails or times out."""
    acc = bits.to(torch.int32).contiguous()
    if dist.is_initialized():
        if group is None:
            raise ValueError("xor_allreduce: a process group exists, so name the group")
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    return acc & 1
