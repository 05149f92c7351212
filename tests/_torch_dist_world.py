"""A gloo world of CPU ranks for the port's sharded paths (imported by
tests/test_torch_parallel.py; its name keeps pytest from collecting it).

`serve` is each spawned rank's loop: it joins the world through a FileStore,
then runs every task its queue brings, (name, dp, sp, payload), and answers
(rank, "ok", result) or (rank, "error", traceback) on the result queue until
it gets None.  Every rank runs every task, so all of them build each mesh
(new_group needs every rank); a rank outside the mesh answers None.  The
ranks import torch and the port only.
"""
from __future__ import annotations

import traceback

import numpy as np
import torch
import torch.distributed as dist

from micro_aes_tpu_torch.core.cipher import encrypt_blocks_np
from micro_aes_tpu_torch.modes import seal
from micro_aes_tpu_torch.modes.xts_bulk import _xts_key_setup
from micro_aes_tpu_torch import parallel as par

CPU = torch.device("cpu")
_MESHES: dict = {}


def mesh_of(dp: int, sp: int):
    """One mesh per shape and world (every rank builds it on the same task)."""
    if (dp, sp) not in _MESHES:
        _MESHES[dp, sp] = par.make_mesh(dp, sp, device="cpu")
    return _MESHES[dp, sp]


def _j0(nonces) -> np.ndarray:
    j0 = np.zeros((len(nonces), 16), np.uint8)
    for i, n in enumerate(nonces):
        j0[i, :12] = np.frombuffer(n, np.uint8)
        j0[i, 15] = 1
    return j0


def _gcm(mesh, p, fused: bool):
    """This rank's slice of an sp-sharded GCM call: p = key, nonces, aad,
    data uint8[B, N, 16], open."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    d, s = mesh.coords
    data, n = p["data"], p["data"].shape[1]
    l = n // sp
    kp, tables = seal.gcm_key_setup(p["key"], device="cpu")
    j0 = _j0(p["nonces"])
    ek = encrypt_blocks_np(p["key"], j0)
    local = par.host_local_batch(mesh, data)[:, s * l:(s + 1) * l].contiguous()
    j0_l, ek_l = par.host_local_batch(mesh, j0), par.host_local_batch(mesh, ek)
    if not fused:
        adj = par.shard_adjust_matrices(tables[3], l, sp, device="cpu")[s:s + 1]
        return par.gcm_seal_sharded_fn(mesh, n)(kp, tables, adj, j0_l, ek_l, local)
    adj = par.shard_adjust_matrices_fused(tables[3], l, sp, device="cpu")[s:s + 1]
    acc, shift, alen = par.sharded_aad_args(p["key"], p["aad"], n, data.shape[0] // dp,
                                            device="cpu")
    fn = par.gcm_sharded_fused_fn(mesh, n, aad_bytes=alen, open_direction=p["open"])
    return fn(kp, tables, adj, j0_l, ek_l, local, acc, shift)


def _twin(mesh, name: str, p):
    """This rank's slice of a dp twin's call: the batch-axis arguments of p
    split by host_local_batch, the replicated ones whole."""
    local = {k: par.host_local_batch(mesh, v) for k, v in p.get("split", {}).items()}
    whole = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in p.get("whole", {}).items()}
    if name == "seal_batch":
        fn = par.seal_batch_sharded_fn(mesh, p["b"], p["wm"])
        return fn(*(local[k] for k in ("kp_stack", "j0w", "front", "mask", "sel",
                                       "len_bits", "ptw")))
    if name == "xts":
        kp1, kp2 = _xts_key_setup(p["keys"], CPU)
        fn = par.xts_sectors_sharded_fn(mesh, p["r"], decrypt=p["decrypt"])
        return fn(kp1, kp2, local["tweaks"], local["ptw"])
    if name == "chain":
        w = whole["kpw"].shape[-1] // mesh.shape["dp"]
        kpw = whole["kpw"][..., mesh.dp_idx * w:(mesh.dp_idx + 1) * w].contiguous()
        third = p["nb"] if p["kind"] == "ofb" else local["blocks"]
        return par.chain_sharded_fn(mesh, p["kind"])(kpw, local["ivs"], third)
    if name == "aead":
        fn = par.aead_sharded_fn(mesh, p["kind"], decrypt=p["decrypt"])
        return fn(*(local[k] for k in ("rks", "c0", "init", "blocks", "nvalid", "tail",
                                       "lastadd")))
    if name == "gcm_chain":
        return par.gcm_chain_sharded_fn(mesh)(*(local[k] for k in (
            "rks", "h", "ej0", "c0", "init", "blocks", "nvalid", "lenb")))
    if name == "siv":
        return par.siv_sharded_fn(mesh)(*(local[k] for k in (
            "rks1", "rks2", "init", "blocks", "nvalid", "tail", "lastadd", "prevadd")))
    raise ValueError(f"unknown task {name!r}")


def run_task(name: str, dp: int, sp: int, payload):
    mesh = mesh_of(dp, sp)
    if mesh.coords is None:
        return None
    if name == "mesh":  # this rank's coordinates, and a grid larger than the world
        try:
            par.make_mesh(4, 2, device="cpu")
        except ValueError as e:
            return mesh.coords, str(e)
        return mesh.coords, None
    if name in ("gcm_fused", "gcm_k2"):
        out = _gcm(mesh, payload, name == "gcm_fused")
    else:
        out = _twin(mesh, name, payload)
    return mesh.coords, tuple(t.numpy() for t in out) if isinstance(out, tuple) else out.numpy()


def serve(rank: int, world: int, store_path: str, tasks, results) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=par.PG_TIMEOUT)
    try:
        while (task := tasks.get()) is not None:
            try:
                results.put((rank, "ok", run_task(*task)))
            except Exception:
                results.put((rank, "error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()
