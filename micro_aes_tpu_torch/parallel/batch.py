"""Batch-axis data parallelism for the multi-tenant engines.

The sp-sharded GCM (parallel/sharded.py) splits the block axis of one
message and pays one XOR all-reduce per tag.  The engines here scale the
other way: B independent (key, message) pairs split over the mesh's dp
ranks with no collective at all; each rank runs the port's engine on its
slice of the batch.  Every built callable takes this rank's local slices,
in the JAX package's argument contracts, and returns its slice of the
result; the engines dispatch on the tensors' device (the kernels on CUDA,
their plain versions on the CPU), so the callables check that the slices
lie on the mesh's device.

Where the engine is a lane-packed kernel (K10, K11/K12's K15 and K13), the
rank builds the kernel's operands (lane-packed key planes, halving tables)
from the contract's round keys and pads its batch to whole 32-lane words
with zero-length messages (all-zero rows under the last key), which cannot
touch a real lane.  Multi-host:
feed each rank its slice with parallel/multihost.host_local_batch.
"""
from __future__ import annotations

import torch

from ..modes.bulk import _lane_keys, _rows
from ..modes.seal_batch import _seal_batch_core
from ..modes.xts_bulk import _row_base_powers_t, xts_sectors_stream_kernel
from ..ops.aead_kernels import aead_chain_fused, siv_seal_chain_fused
from ..ops.chain import gcm_chain_fused, ghash_halving_table
from ..ops.chain_kernels import chain_packed_fused, ofb_packed_fused
from ..ops.gf128 import mul_gf128
from .mesh import Mesh


def _on_mesh(mesh: Mesh, name: str, *tensors) -> None:
    for t in tensors:
        if t.device != mesh.device:
            raise ValueError(f"{name}: an input is on {t.device}, the mesh on {mesh.device}")


def _lanes(x: torch.Tensor) -> int:
    """Zero rows that pad a batch to whole 32-lane words."""
    return (-x.shape[0]) % 32


def _keys(rks: torch.Tensor, pad: int) -> torch.Tensor:
    """Lane-packed key planes of a round-key stack uint8[Bl, R+1, 16], the
    padded lanes under its last key (modes/bulk._lane_keys)."""
    return _lane_keys(rks.cpu().numpy(), pad, rks.device)


def seal_batch_sharded_fn(mesh: Mesh, b: int, wm: int):
    """The multi-key matrix-GHASH GCM core (modes/seal_batch._seal_batch_core,
    its cipher on K9's uniform entry) over the mesh's dp axis; b must
    divide by dp.  Returns fn(kp_stack, j0w, front, mask, sel, len_bits,
    ptw) -> (out stream, tags) on this rank's slices of the core's
    arguments (each split on its batch-derived leading axis)."""
    dp = mesh.shape["dp"]
    if b % dp:
        raise ValueError(f"seal_batch_sharded_fn: a batch of {b} does not split over dp={dp}")
    local_b = b // dp

    def fn(kp_stack, j0w, front, mask, sel, len_bits, ptw):
        _on_mesh(mesh, "seal_batch_sharded_fn", kp_stack, j0w, front, mask, sel, len_bits, ptw)
        return _seal_batch_core(kp_stack, j0w, front, mask, sel, len_bits, ptw, local_b, wm)

    return fn


def xts_sectors_sharded_fn(mesh: Mesh, r_per_sector: int, decrypt: bool = False):
    """Disk-sector XTS over the mesh's dp axis: sectors are independent, so
    the tweaks shard with their sectors and the w-major stream on whole
    sectors.  Returns fn(kp1, kp2, tweaks[Sl,16], ptw[Sl*R,128]) -> the
    output stream (modes/xts_bulk.xts_sectors_stream_kernel: K2 for the
    tweaks, K6 for the body); r_per_sector = sector blocks / 32."""
    pows = _row_base_powers_t(r_per_sector, mesh.device)

    def fn(kp1, kp2, tweaks, ptw):
        _on_mesh(mesh, "xts_sectors_sharded_fn", kp1, kp2, tweaks, ptw)
        if ptw.shape[0] != tweaks.shape[0] * r_per_sector:
            raise ValueError(f"xts_sectors_sharded_fn: {ptw.shape[0]} stream rows for "
                             f"{tweaks.shape[0]} sectors of {r_per_sector} rows")
        return xts_sectors_stream_kernel(kp1, kp2, pows, tweaks, ptw, decrypt)

    return fn


def chain_sharded_fn(mesh: Mesh, kind: str):
    """The lane-packed serial chains (CBC/CFB encrypt, the OFB keystream;
    K13) over the mesh's dp axis: per-lane keys shard with their lanes.
    Returns fn(kpw[R+1,8,16,Wl], ivs[Bl,16], blocks[Bl,nb,16]) ->
    uint8[Bl,nb,16]; for "ofb" the third argument gives the step count (an
    int, or an array of nb entries as in the JAX package).  The local batch
    must be a multiple of 32: a word of lanes per rank at least."""
    if kind not in ("cbc", "cfb", "ofb"):
        raise ValueError(f"chain_sharded_fn: unknown kind {kind!r}")

    def fn(kpw, ivs, blocks):
        if ivs.shape[0] % 32:
            raise ValueError(f"chain_sharded_fn: the local batch {ivs.shape[0]} must be a "
                             "multiple of 32")
        if kind == "ofb":
            _on_mesh(mesh, "chain_sharded_fn", kpw, ivs)
            nb = blocks if isinstance(blocks, int) else len(blocks)
            return ofb_packed_fused(kpw, ivs, nb)
        _on_mesh(mesh, "chain_sharded_fn", kpw, ivs, blocks)
        return chain_packed_fused(kind, kpw, ivs, blocks)

    return fn


def aead_sharded_fn(mesh: Mesh, kind: str, decrypt: bool = False):
    """The one-pass CCM/EAX batch engine (K11: a K15 keystream pass and a
    K13 MAC) over the mesh's dp axis.  Returns fn(rks[Bl,R+1,16], c0, init,
    blocks[Bl,nb,16], nvalid[Bl], tail, lastadd) -> (out[Bl,nb,16],
    tag[Bl,16]), the per-message rows uint8[Bl,16]."""
    if kind not in ("ccm", "eax"):
        raise ValueError(f"aead_sharded_fn: unknown kind {kind!r}")

    def fn(rks, c0, init, blocks, nvalid, tail, lastadd):
        _on_mesh(mesh, "aead_sharded_fn", rks, c0, init, blocks, nvalid, tail, lastadd)
        bl, pad = blocks.shape[0], _lanes(blocks)
        rows = [_rows(x, pad, mesh.device) for x in (c0, init, blocks, nvalid.to(torch.int32),
                                                      tail, lastadd)]
        out, tag = aead_chain_fused(kind, _keys(rks, pad), *rows, decrypt=decrypt)
        return out[:bl], tag[:bl]

    return fn


def gcm_chain_sharded_fn(mesh: Mesh):
    """The value-chain multi-key GCM engine (K10) over the mesh's dp axis.
    Returns fn(rks[Bl,R+1,16], h, ej0, c0, init, blocks[Bl,nb,16] (whole
    blocks), nvalid[Bl], lenb) -> (ct[Bl,nb,16], tags[Bl,16]); h, ej0, c0,
    init and lenb uint8[Bl,16].  K10 folds GHASH from init over each
    message's nvalid blocks with the halving table of its H; the tag is
    E(J0) ^ (G ^ lenb) * H."""
    def fn(rks, h, ej0, c0, init, blocks, nvalid, lenb):
        _on_mesh(mesh, "gcm_chain_sharded_fn", rks, h, ej0, c0, init, blocks, nvalid, lenb)
        bl, pad = blocks.shape[0], _lanes(blocks)
        tail = torch.full((bl + pad, 16), 0xFF, dtype=torch.uint8, device=mesh.device)
        out, g = gcm_chain_fused(_keys(rks, pad), ghash_halving_table(_rows(h, pad, mesh.device)),
                                 *(_rows(x, pad, mesh.device) for x in (c0, init, blocks, nvalid)),
                                 tail)
        return out[:bl], ej0 ^ mul_gf128(h, g[:bl] ^ lenb)

    return fn


def siv_sharded_fn(mesh: Mesh):
    """The SIV batch engine (K12: the S2V fold on K13's MAC, then the CTR
    pass on K15) over the mesh's dp axis.  Returns fn(rks1[Bl,R+1,16],
    rks2, init, blocks[Bl,nb,16], nvalid[Bl], tail, lastadd, prevadd) ->
    (ct[Bl,nb,16], iv[Bl,16])."""
    def fn(rks1, rks2, init, blocks, nvalid, tail, lastadd, prevadd):
        _on_mesh(mesh, "siv_sharded_fn", rks1, rks2, init, blocks, nvalid, tail, lastadd,
                 prevadd)
        bl, pad = blocks.shape[0], _lanes(blocks)
        rows = [_rows(x, pad, mesh.device) for x in (init, blocks, nvalid.to(torch.int32), tail,
                                                      lastadd, prevadd)]
        ct, iv = siv_seal_chain_fused(_keys(rks1, pad), _keys(rks2, pad), *rows)
        return ct[:bl], iv[:bl]

    return fn
