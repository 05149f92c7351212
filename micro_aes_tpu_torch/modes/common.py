"""Shared glue of the per-message modes: round keys per device, single-block
and batched block encryption, CTR keystreams and GHASH block preparation.

The per-message modes run plain PyTorch on the requested device (the JAX
package runs them as jnp, with no Pallas kernel): the byte-oriented cipher
of core/cipher over counter blocks from ops/counter.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.cipher import decrypt_blocks, encrypt_blocks
from ..core.keyschedule import expand_key
from ..ops.counter import counter_blocks
from ..utils.bytesio import BLOCK, to_blocks, to_u8
from ..utils.keycache import key_cache


def prepare_counter_base(base: torch.Tensor, mode: str):
    """The counter conventions of the CTR-based modes (ctr_based_modes,
    micro_aes.c:903-909) -> (base, offset, endian): CTR counts from the
    base itself, GCM from base + 1, both big-endian; GCM-SIV sets bit 7 of
    byte 15 and counts little-endian in bytes 0..3."""
    if mode == "ctr":
        return base, 0, "be"
    if mode == "ccm_gcm":
        return base, 1, "be"
    if mode == "gcm_siv":
        base = base.clone()
        base[15] |= 0x80
        return base, 0, "le32"
    raise ValueError(f"unknown counter mode {mode!r}")


@key_cache(maxsize=512)
def round_keys(key: bytes, device: torch.device) -> torch.Tensor:
    """Round keys uint8[R+1,16] of `key` on `device` (cached)."""
    return torch.from_numpy(np.array(expand_key(key))).to(device)


def enc_block(key: bytes, block, device) -> torch.Tensor:
    """E_K of one 16-byte block (bytes or uint8 array/tensor) -> uint8[16]
    on `device`."""
    dev = torch.device(device)
    x = block if torch.is_tensor(block) else torch.from_numpy(to_u8(block).copy())
    return encrypt_blocks(round_keys(bytes(key), dev), x.to(dev).reshape(1, BLOCK))[0]


def _blocks_np(cipher, key: bytes, blocks: np.ndarray, device) -> np.ndarray:
    x = torch.from_numpy(np.ascontiguousarray(blocks, dtype=np.uint8)).to(device)
    return cipher(round_keys(bytes(key), torch.device(device)), x).cpu().numpy()


def enc_blocks_np(key: bytes, blocks: np.ndarray, device) -> np.ndarray:
    """E_K of a host batch uint8[N,16], computed on `device` -> host
    uint8[N,16] (one batched call of the byte cipher)."""
    return _blocks_np(encrypt_blocks, key, blocks, device)


def dec_blocks_np(key: bytes, blocks: np.ndarray, device) -> np.ndarray:
    """D_K of a host batch uint8[N,16] on `device` (as enc_blocks_np)."""
    return _blocks_np(decrypt_blocks, key, blocks, device)


def keystream(key: bytes, base: torch.Tensor, mode: str, nblocks: int) -> torch.Tensor:
    """E(ctr_i) for i = 0..nblocks-1 under the mode's counter convention
    ("ctr", "ccm_gcm" or "gcm_siv"), on base's device (the serial loop of
    CTR_cipher, micro_aes.c:919-950, as one batched call)."""
    base, offset, endian = prepare_counter_base(base, mode)
    ctrs = counter_blocks(base, nblocks, offset, endian)
    return encrypt_blocks(round_keys(bytes(key), base.device), ctrs)


def ctr_xcrypt(key: bytes, base: torch.Tensor, mode: str, data) -> bytes:
    """data ^ keystream: the body of CTR_cipher for whole and partial
    blocks.  Returns host bytes."""
    flat = to_u8(data)
    n = len(flat)
    ks = keystream(key, base, mode, -(-n // BLOCK)).reshape(-1)[:n]
    x = torch.from_numpy(flat.copy()).to(base.device)
    return bytes((x ^ ks).cpu().numpy())


def xmac_blocks(data) -> np.ndarray:
    """xMac block preparation (micro_aes.c:551-571): zero-padded whole
    blocks; folding a zero-padded tail equals the reference's partial
    xor-then-mix."""
    return to_blocks(data)
