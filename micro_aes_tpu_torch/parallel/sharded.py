"""Mesh-sharded bulk AES-GCM: one message's block axis split over the sp
ranks of a (dp, sp) mesh.

Layout, as in the JAX package:
  * dp: independent messages, each rank of an sp group holds the same
    messages;
  * sp: the block axis within each message.  Shard s of L blocks makes its
    own counter window from the global block index (start = s*L - 1
    relative to J0, no communication), ciphers it, folds a local GHASH
    partial, applies its adjustment M^(L*(S-1-s)), and the tag comes from
    ONE XOR all-reduce over the sp group (GF(2) addition is the parity of
    an integer sum).

Each engine is a per-shard body (`fused_shard_body`, `seal_shard_body`),
which computes (out, adjusted partial) for one shard index, then the
collective (`_dist.xor_allreduce` over the rank's sp group), then the tags
(`sharded_tags`: the AAD fold and the length-block finalize).  The built
callables take this rank's local slices (its dp rows, its sp shard) and
return its out slice and the tags, which are the same on every rank of an
sp group.  The bodies run K1 (`modes/seal.fused_seal_body`, one launch per
message and shard) or K2 (`modes/seal.plane_seal_body`); the GF(2)
products are float64 (ops/ghash_bulk).
"""
from __future__ import annotations

import numpy as np
import torch

from ..modes.seal import (
    _STD2PLANE,
    _aad_prep,
    _ghash_pad_front,
    _len_block,
    fused_seal_body,
    fused_trailing_pad,
    gcm_key_setup,
    plane_seal_body,
)
from ..ops.gf128 import blocks_to_bits, gf2_matinv_np, mat_power_gf2_np
from ..ops.ghash_bulk import CHUNK2, _gf2_matmul_i8, ghash_finalize, ghash_from_bits
from ._dist import xor_allreduce
from .mesh import Mesh


def _host_matrix(m) -> np.ndarray:
    return (m.cpu().numpy() if torch.is_tensor(m) else np.asarray(m)).astype(np.uint8)


def _mat_mul_gf2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a.astype(np.int64) @ b.astype(np.int64) % 2).astype(np.uint8)


def _shard_powers(m_l: np.ndarray, num_shards: int) -> list[np.ndarray]:
    """[I, M_L, ..., M_L^(S-1)]."""
    mats = [np.eye(128, dtype=np.uint8)]
    for _ in range(num_shards - 1):
        mats.append(_mat_mul_gf2(mats[-1], m_l))
    return mats


def shard_adjust_matrices(m_h, blocks_per_shard: int, num_shards: int, *,
                          device="cuda") -> torch.Tensor:
    """adj[s] = (M^(L*(S-1-s)))^T as int8 [S, 128, 128] on `device`, the
    cross-shard combine of the K2 engine (gcm_seal_sharded_fn)."""
    mats = _shard_powers(mat_power_gf2_np(_host_matrix(m_h), blocks_per_shard), num_shards)
    stack = np.stack([mats[num_shards - 1 - s].T for s in range(num_shards)])
    return torch.from_numpy(stack.astype(np.int8)).to(device)


def shard_adjust_matrices_fused(m_h, blocks_per_shard: int, num_shards: int,
                                chunk2: int = CHUNK2, *, device="cuda") -> torch.Tensor:
    """The combine matrices of the fused engine: A_s = M^(L*(S-1-s)) .
    M^(-z), z the local trailing stream pad (modes/seal.fused_trailing_pad),
    so one matrix takes both the shard's offset and the pad's compensation;
    transposed, int8 [S, 128, 128] on `device`.  chunk2 names the GHASH
    tables' level-2 width, which the port fixes at CHUNK2."""
    if chunk2 != CHUNK2:
        raise ValueError(f"the port's GHASH tables have chunk2 = {CHUNK2}, not {chunk2}")
    m = _host_matrix(m_h)
    z = fused_trailing_pad(blocks_per_shard)
    minv_z = gf2_matinv_np(mat_power_gf2_np(m, z)) if z else np.eye(128, dtype=np.uint8)
    mats = _shard_powers(mat_power_gf2_np(m, blocks_per_shard), num_shards)
    stack = np.stack([_mat_mul_gf2(mats[num_shards - 1 - s], minv_z).T
                      for s in range(num_shards)])
    return torch.from_numpy(stack.astype(np.int8)).to(device)


def sharded_aad_args(key: bytes, aad: bytes, total_blocks: int, batch: int, *,
                     device="cuda"):
    """The per-batch AAD arguments of the fused sharded engine: (aad_acc
    int8[B, 128], the AAD's plane-order GHASH partial; aad_shift_t int8[128,
    128] = (M^n_ct)^T; aad_bytes), on `device`.  With no AAD the partial is
    zeros and the shift the identity, so the fold changes nothing."""
    dev = torch.device(device)
    aad = bytes(aad or b"")
    if not aad:
        return (torch.zeros((batch, 128), dtype=torch.int8, device=dev),
                torch.eye(128, dtype=torch.int8, device=dev), 0)
    key = bytes(key)
    _, tables = gcm_key_setup(key, device=dev)
    blocks, alen, shift_t = _aad_prep(key, aad, total_blocks, dev)
    perm = torch.as_tensor(_STD2PLANE, device=dev)
    abits = blocks_to_bits(blocks).to(torch.int8)[:, perm]
    g_aad = ghash_from_bits(tables, _ghash_pad_front(abits)).to(torch.int8)
    return g_aad.expand(batch, 128).contiguous(), shift_t, alen


def _check_local(mesh: Mesh, l_shard: int, pt: torch.Tensor, *others) -> None:
    """The rank's slices lie on its device (nothing runs elsewhere) and
    hold whole shards."""
    for t in (pt, *others):
        if t.device != mesh.device:
            raise ValueError(f"sharded GCM: an input is on {t.device}, the mesh on {mesh.device}")
    if pt.dim() != 3 or pt.shape[1:] != (l_shard, 16):
        raise ValueError(f"sharded GCM: local data {tuple(pt.shape)}, expected [Bl, {l_shard}, 16]")


def _shard_length(mesh: Mesh, total_blocks: int) -> int:
    sp = mesh.shape["sp"]
    if total_blocks % sp:
        raise ValueError(f"{total_blocks} blocks do not split over sp={sp}")
    l_shard = total_blocks // sp
    if l_shard % 32:
        raise ValueError(f"the shard length {l_shard} must be a multiple of 32 blocks")
    return l_shard


def fused_shard_body(kp, tables, adj_s, j0, pt, shard: int, l_shard: int,
                     open_direction: bool = False):
    """Shard `shard` of every local message on K1: j0 uint8[Bl,16], pt
    uint8[Bl,L,16], adj_s int8[128,128] (its shard_adjust_matrices_fused
    entry) -> (out uint8[Bl,L,16], g_adj int32 0/1 [Bl,128], the partials
    before the cross-shard XOR).  Open folds GHASH over the input."""
    start = shard * l_shard - 1
    outs, accs = [], []
    for j, x in zip(j0, pt):
        out, _, acc = fused_seal_body(kp, tables, j, x, open_direction, start)
        outs.append(out)
        accs.append(acc)
    return torch.stack(outs), _gf2_matmul_i8(torch.stack(accs).to(torch.int8), adj_s)


def sharded_tags(tables, g, ek_j0, aad_acc, aad_shift_t, total_blocks: int,
                 aad_bytes: int = 0) -> torch.Tensor:
    """The tags from the XORed partials g int 0/1 [Bl, 128]: the AAD fold
    in front, then the length block and E(J0) -> uint8[Bl, 16]."""
    g = g ^ _gf2_matmul_i8(aad_acc, aad_shift_t)
    lenb = _len_block(total_blocks, aad_bytes, g.device)
    return ek_j0 ^ ghash_finalize(tables, g.to(torch.uint8), lenb)


def gcm_sharded_fused_fn(mesh: Mesh, total_blocks: int, aad_bytes: int = 0,
                         open_direction: bool = False):
    """The fused sharded GCM engine (K1 per shard).  Returns fn(kp, tables,
    adj, j0[Bl,16], ek_j0[Bl,16], pt[Bl,L,16], aad_acc[Bl,128] int8,
    aad_shift_t[128,128] int8) -> (out[Bl,L,16], tag[Bl,16]) on this
    rank's slices: its dp rows of the batch and its sp shard of the blocks
    (adj: its entry of shard_adjust_matrices_fused, [1, 128, 128];
    aad_acc/aad_shift_t from sharded_aad_args).  open_direction=True folds
    GHASH over the input (GCM open); the caller verifies the tag before it
    releases the plaintext (modes/seal.gcm_open's order)."""
    l_shard = _shard_length(mesh, total_blocks)

    def fn(kp, tables, adj, j0, ek_j0, pt, aad_acc, aad_shift_t):
        _check_local(mesh, l_shard, pt, kp, adj, j0, ek_j0, aad_acc, aad_shift_t)
        out, g_adj = fused_shard_body(kp, tables, adj[0], j0, pt, mesh.sp_idx, l_shard,
                                      open_direction)
        g = xor_allreduce(g_adj, mesh.sp_group)
        return out, sharded_tags(tables, g, ek_j0, aad_acc, aad_shift_t, total_blocks,
                                 aad_bytes)

    return fn


def gcm_seal_sharded_fused_fn(mesh: Mesh, total_blocks: int):
    """Seal direction, no AAD, with gcm_seal_sharded_fn's signature: fn(kp,
    tables, adj, j0, ek_j0, pt) -> (ct, tag); adj from
    shard_adjust_matrices_fused."""
    inner = gcm_sharded_fused_fn(mesh, total_blocks)

    def fn(kp, tables, adj, j0, ek_j0, pt):
        dev = mesh.device
        return inner(kp, tables, adj, j0, ek_j0, pt,
                     torch.zeros((j0.shape[0], 128), dtype=torch.int8, device=dev),
                     torch.eye(128, dtype=torch.int8, device=dev))

    return fn


def seal_shard_body(kp, tables, adj_s, j0, pt, shard: int, l_shard: int):
    """Shard `shard` of every local message on K2 (modes/seal.
    plane_seal_body, the JAX package's _local_seal) -> (ct uint8[Bl,L,16],
    g_adj int32 0/1 [Bl,128]); adj_s its shard_adjust_matrices entry."""
    start = shard * l_shard - 1
    cts, _, accs = zip(*(plane_seal_body(kp, tables, j, x, start) for j, x in zip(j0, pt)))
    return torch.stack(cts), _gf2_matmul_i8(torch.stack(accs).to(torch.int8), adj_s)


def gcm_seal_sharded_fn(mesh: Mesh, total_blocks: int):
    """The sharded seal on K2 (the v2 pipeline per shard).  Returns fn(kp,
    tables, adj, j0[Bl,16], ek_j0[Bl,16], pt[Bl,L,16]) -> (ct[Bl,L,16],
    tag[Bl,16]) on this rank's slices; adj its entry of
    shard_adjust_matrices, [1, 128, 128].  J0's low word must be 1 (a
    12-byte nonce)."""
    l_shard = _shard_length(mesh, total_blocks)

    def fn(kp, tables, adj, j0, ek_j0, pt):
        _check_local(mesh, l_shard, pt, kp, adj, j0, ek_j0)
        ct, g_adj = seal_shard_body(kp, tables, adj[0], j0, pt, mesh.sp_idx, l_shard)
        g = xor_allreduce(g_adj, mesh.sp_group)
        lenb = _len_block(total_blocks, 0, g.device)
        return ct, ek_j0 ^ ghash_finalize(tables, g.to(torch.uint8), lenb)

    return fn
