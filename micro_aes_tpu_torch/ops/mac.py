"""MAC folds: GHASH for the per-message and batch GCM paths (plain PyTorch;
the JAX package has no kernel here either), the CBC-MAC of CMAC and of the
batch engines, and the host doublings of the CMAC/OCB/XTS subkeys.

  * `ghash_fold` — the serial Horner fold G <- M_H (G ^ b_i) of gHash
    (micro_aes.c:1127-1137) with the per-key bit matrix M_H
    (ops/gf128.ghash_matrix), as float64 products of 0/1 bits (exact
    whatever the process's matmul precision, see ops/ghash_bulk);
  * `ghash_fold_batch` — the same over many messages, each with its own
    H.  The product by H is XOR_i bit_i(v) * halve^i(H) over the table of
    H's 128 halvings (`halving_table`, the table the chain kernel's JAX
    twin reads), one masked XOR per step (`mul_by_table`).

  * `cbcmac_fold` / `cbcmac_fold_batch` — the serial CBC-MAC fold
    M <- E(M ^ x_i) of xMac (micro_aes.c:551-571) with the byte cipher, for
    one message or a batch, one block per step;
  * `cbcmac_fold_batch_auto` — the batch engines' CBC-MAC: the batch
    lane-packed 32 messages per word (a key per lane) through K13's masked
    CBC-MAC (ops/chain_kernels.cbcmac_packed_fused), the kernel on CUDA and
    its plain version on the CPU.

The folds take `nvalid` and leave the blocks at or past it out, so callers
can pad messages of different lengths into one array.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.bitslice import key_planes_packed
from ..core.cipher import encrypt_blocks
from ..utils.bytesio import u32_tensor
from ..utils.keycache import key_cache
from .chain_kernels import cbcmac_packed_fused
from .gf128 import bits_to_blocks, blocks_to_bits, halve_be


def ghash_fold(m_h: torch.Tensor, init: torch.Tensor, blocks: torch.Tensor,
               nvalid: int) -> torch.Tensor:
    """G_{i+1} = M_H (G_i ^ b_i) over blocks[:nvalid]: m_h uint8[128,128],
    init uint8[16], blocks uint8[N,16], all on one device -> uint8[16]."""
    mt = m_h.T.to(torch.float64)
    bb = blocks_to_bits(blocks[:nvalid]).to(torch.int64)
    g = blocks_to_bits(init).to(torch.int64)
    for i in range(bb.shape[0]):
        g = ((g ^ bb[i]).to(torch.float64) @ mt).to(torch.int64) & 1
    return bits_to_blocks(g)


def halving_table(h: torch.Tensor) -> torch.Tensor:
    """uint8[B,16] -> uint8[128,B,16]: row i = halve_be^i(H), so that
    v * H = XOR_i bit_i(v) * row i (mulGF128's bit order)."""
    rows = [h]
    for _ in range(127):
        rows.append(halve_be(rows[-1]))
    return torch.stack(rows)


def xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR of x over its leading axis (a pairwise tree of XORs)."""
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.zeros_like(x[:1])])
        half = x.shape[0] // 2
        x = x[:half] ^ x[half:]
    return x[0]


def masked_xor(bits: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """XOR_i bits[i] * table[i]: bits bool[N,B], table uint8[N,B,16] ->
    uint8[B,16]."""
    sel = torch.where(bits[..., None], table.view(torch.int64), 0)
    return xor_reduce(sel).contiguous().view(torch.uint8)


def mul_by_table(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x * H per row: x uint8[B,16], table = halving_table(H)."""
    return masked_xor(blocks_to_bits(x).T.bool(), table)


def ghash_fold_rows(table: torch.Tensor, init: torch.Tensor,
                    blocks: torch.Tensor, nvalid) -> torch.Tensor:
    """ghash_fold_batch with H given by its halving table [128,B,16]."""
    nvalid = torch.as_tensor(np.asarray(nvalid, np.int64), device=blocks.device)
    g = init
    for i in range(blocks.shape[1]):
        g = torch.where((i < nvalid)[:, None], mul_by_table(g ^ blocks[:, i], table), g)
    return g


def ghash_fold_batch(h: torch.Tensor, init: torch.Tensor, blocks: torch.Tensor,
                     nvalid) -> torch.Tensor:
    """Batched serial GHASH over independent messages: h/init uint8[B,16],
    blocks uint8[B,M,16], nvalid int[B] (a sequence or tensor), all on
    one device -> uint8[B,16].  A loop of M steps on the device."""
    return ghash_fold_rows(halving_table(h), init, blocks, nvalid)


def cbcmac_fold(round_keys: torch.Tensor, init: torch.Tensor, blocks: torch.Tensor,
                nvalid: int) -> torch.Tensor:
    """M_{i+1} = E(M_i ^ x_i) over blocks[:nvalid]: round_keys uint8[R+1,16],
    init uint8[16], blocks uint8[N,16] on one device -> uint8[16]."""
    m = init
    for x in blocks[:nvalid]:
        m = encrypt_blocks(round_keys, m ^ x)
    return m


def cbcmac_fold_batch(rks: torch.Tensor, init: torch.Tensor, blocks: torch.Tensor,
                      nvalid) -> torch.Tensor:
    """Batched CBC-MAC fold with the byte cipher: rks uint8[B,R+1,16],
    init uint8[B,16], blocks uint8[B,M,16], nvalid int[B] (a sequence or
    tensor), all on one device -> uint8[B,16]."""
    nvalid = torch.as_tensor(np.asarray(nvalid, np.int64), device=blocks.device)
    rk = rks.transpose(0, 1)  # a key per row
    acc = init
    for i in range(blocks.shape[1]):
        acc = torch.where((i < nvalid)[:, None], encrypt_blocks(rk, acc ^ blocks[:, i]), acc)
    return acc


@key_cache(maxsize=64)
def _kpw_cached(rks_bytes: bytes, b: int, nr: int, device: torch.device) -> torch.Tensor:
    """Lane-packed key planes int32[nr,8,16,b/32] of a round-key stack (its
    bytes, b keys of nr round keys) on `device`: the CMAC batches fold with
    the same stack again and again."""
    rks = np.frombuffer(rks_bytes, np.uint8).reshape(b, nr, 16)
    return u32_tensor(key_planes_packed(rks), device)


def cbcmac_fold_batch_auto(rks: np.ndarray, init: torch.Tensor, blocks: torch.Tensor,
                           nvalid) -> torch.Tensor:
    """The batched CBC-MAC fold on K13: rks host uint8[B,R+1,16] (one key
    size), init uint8[B,16], blocks uint8[B,M,16] and nvalid int[B] (a
    sequence or tensor) on one device -> uint8[B,16].  The batch is padded
    to a multiple of 32 messages (the last key again, no valid blocks) on
    the device, and its key planes are cached per round-key stack."""
    b = blocks.shape[0]
    dev = blocks.device
    pad = (-b) % 32
    rks = np.asarray(rks, np.uint8)
    if pad:
        rks = np.concatenate([rks, np.repeat(rks[-1:], pad, axis=0)])
    kpw = _kpw_cached(rks.tobytes(), rks.shape[0], rks.shape[1], dev)
    nv = (nvalid.to(dev, torch.int32) if torch.is_tensor(nvalid)
          else torch.as_tensor(np.asarray(nvalid, np.int32), device=dev))
    if pad:
        init = torch.cat([init, init.new_zeros((pad, 16))])
        blocks = torch.cat([blocks, blocks.new_zeros((pad,) + blocks.shape[1:])])
        nv = torch.cat([nv, nv.new_zeros(pad)])
    return cbcmac_packed_fused(kpw, init.contiguous(), blocks.contiguous(), nv)[:b]


# Host-side numpy GF(2^128) doubling (OCB and XTS subkeys and tweaks)

def double_be_np(x: np.ndarray) -> np.ndarray:
    """numpy doubleBblock (micro_aes.c:434-443): big-endian shift left by
    one bit, 0x87 into the last byte if the first bit fell out."""
    x = np.asarray(x, dtype=np.uint8)
    y = ((x << 1) & 0xFF).astype(np.uint8)
    y[..., :-1] |= x[..., 1:] >> 7
    y[..., 15] ^= (x[..., 0] >> 7) * 0x87
    return y


def double_le_np(x: np.ndarray) -> np.ndarray:
    """numpy doubleLblock (micro_aes.c:449-458): the little-endian
    doubling of the XTS tweak, 0x87 into byte 0."""
    x = np.asarray(x, dtype=np.uint8)
    y = ((x << 1) & 0xFF).astype(np.uint8)
    y[..., 1:] |= x[..., :-1] >> 7
    y[..., 0] ^= (x[..., 15] >> 7) * 0x87
    return y
