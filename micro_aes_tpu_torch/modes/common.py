"""Shared glue of the per-message modes: round keys per device, single-block
and batched block encryption, CTR keystreams, GHASH block preparation,
padding, the serial chains of one message and the CMAC machinery.

The parallel parts of the per-message modes run plain PyTorch on the
requested device (the JAX package runs them as jnp): the byte-oriented
cipher of core/cipher over whole batches of blocks, or over counter blocks
from ops/counter.  The serial parts (CBC/CFB encrypt, the OFB keystream,
the CBC-MAC of CMAC) run through K13 (ops/chain_kernels) as a batch of one
message padded to 32 lanes: one launch per message on CUDA, the kernel's
plain version on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.cipher import decrypt_blocks, encrypt_blocks
from ..core.keyschedule import expand_key
from ..errors import DataLengthError
from ..ops.chain_kernels import chain_packed_fused, ofb_packed_fused
from ..ops.counter import counter_blocks
from ..ops.mac import _kpw_cached, cbcmac_fold_batch_auto, double_be_np, double_le_np
from ..utils.bytesio import BLOCK, to_blocks, to_u8
from ..utils.keycache import key_cache


def prepare_counter_base(base: torch.Tensor, mode: str):
    """The counter conventions of the CTR-based modes (ctr_based_modes,
    micro_aes.c:903-909) -> (base, offset, endian): CTR counts from the
    base itself, CCM and GCM from base + 1, SIV from the base with bit 7 of
    bytes 8 and 12 cleared (micro_aes.c:931-934), all big-endian; GCM-SIV
    sets bit 7 of byte 15 and counts little-endian in bytes 0..3."""
    if mode == "ctr":
        return base, 0, "be"
    if mode == "ccm_gcm":
        return base, 1, "be"
    if mode == "siv":
        base = base.clone()
        base[8] &= 0x7F
        base[12] &= 0x7F
        return base, 0, "be"
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
    x = torch.from_numpy(np.array(blocks, dtype=np.uint8)).to(device)
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
    ("ctr", "ccm_gcm", "siv" or "gcm_siv"), on base's device (the serial
    loop of CTR_cipher, micro_aes.c:919-950, as one batched call)."""
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


# padding (padBlock, micro_aes.c:610-621)

PAD_ZERO, PAD_PKCS7, PAD_ISO7816 = 0, 1, 2


def pad_message(data: np.ndarray, padding: int) -> tuple[np.ndarray, bool]:
    """Return (padded bytes, whether a final padded block exists): zeros up
    to a block (none for a whole-block message), PKCS#7, or ISO/IEC 7816-4
    (0x80 then zeros); the last two always add at least one byte."""
    n = len(data)
    r = n % BLOCK
    if padding == PAD_ZERO:
        if r == 0:
            return data, False
        out = np.zeros(n + BLOCK - r, np.uint8)
        out[:n] = data
        return out, True
    pad = BLOCK - r  # a whole block of padding when r == 0
    out = np.zeros(n + pad, np.uint8)
    out[:n] = data
    if padding == PAD_PKCS7:
        out[n:] = pad
    else:  # ISO/IEC 7816-4
        out[n] = 0x80
    return out, True


def check_block_multiple(nbytes: int):
    if nbytes % BLOCK:
        raise DataLengthError(f"length {nbytes} is not a multiple of {BLOCK}")


# the serial chains of one message, through K13 as lane 0 of 32

def _one_message(key: bytes, iv, device):
    """(key planes with `key` in all 32 lanes, the 32 ivs with iv in lane 0)
    on `device`."""
    dev = torch.device(device)
    rk = np.array(expand_key(key))
    kpw = _kpw_cached(np.repeat(rk[None], 32, axis=0).tobytes(), 32, rk.shape[0], dev)
    ivs = torch.zeros((32, BLOCK), dtype=torch.uint8, device=dev)
    ivs[0] = torch.from_numpy(to_u8(iv)[:BLOCK].copy())
    return kpw, ivs


def chain_np(kind: str, key: bytes, iv, blocks: np.ndarray, device) -> np.ndarray:
    """One message's CBC ("cbc") or CFB ("cfb") encrypt chain over host
    blocks uint8[N,16] from iv, on `device` -> host uint8[N,16]."""
    kpw, ivs = _one_message(key, iv, device)
    buf = torch.zeros((32,) + blocks.shape, dtype=torch.uint8, device=ivs.device)
    buf[0] = torch.from_numpy(np.array(blocks, np.uint8))
    return chain_packed_fused(kind, kpw, ivs, buf)[0].cpu().numpy()


def ofb_keystream_np(key: bytes, iv, nblocks: int, device) -> np.ndarray:
    """One message's OFB keystream, nblocks blocks from iv, on `device` ->
    host uint8[nblocks,16]."""
    kpw, ivs = _one_message(key, iv, device)
    return ofb_packed_fused(kpw, ivs, nblocks)[0].cpu().numpy()


# CMAC machinery (cMac/getSubkeys, micro_aes.c:573-605)

@key_cache(maxsize=512)
def cmac_subkeys(key: bytes, device, little_endian: bool = False):
    """(K1, K2) per getSubkeys: K1 = double(E_K(0)), K2 = double(K1), as
    read-only host arrays (E_K(0) computed on `device`); little_endian takes
    the little-endian doubling (EAX')."""
    dbl = double_le_np if little_endian else double_be_np
    L = enc_block(key, bytes(BLOCK), device).cpu().numpy()
    K1 = dbl(L)
    K2 = dbl(K1)
    K1.setflags(write=False)
    K2.setflags(write=False)
    return K1, K2


def cbcmac_np(key: bytes, init, blocks: np.ndarray, device) -> np.ndarray:
    """Fold M = E(M ^ x_i) over host blocks uint8[N,16] from init, on
    `device` (K13's CBC-MAC, one message) -> host uint8[16]."""
    n = blocks.shape[0]
    if n == 0:
        return np.asarray(init, np.uint8).copy()
    dev = torch.device(device)
    rks = np.array(expand_key(key))[None]
    init_t = torch.from_numpy(np.array(init, np.uint8).reshape(1, BLOCK)).to(dev)
    blocks_t = torch.from_numpy(np.array(blocks, np.uint8)[None]).to(dev)
    return cbcmac_fold_batch_auto(rks, init_t, blocks_t, [n])[0].cpu().numpy()


def cmac_digest(key: bytes, data, device, init=None, subkeys=None,
                little_endian: bool = False) -> np.ndarray:
    """cMac (micro_aes.c:576-590): CBC-MAC with the K1/K2 last-block tweak,
    optionally continuing from a nonzero init (EAX, OCB and SIV use it) ->
    host uint8[16]."""
    K1, K2 = subkeys if subkeys is not None else cmac_subkeys(key, device, little_endian)
    flat = to_u8(data)
    n = len(flat)
    s = (n - 1) % BLOCK + 1 if n else 0
    head = flat[: n - s].reshape(-1, BLOCK)
    last = np.zeros(BLOCK, np.uint8)
    last[:s] = flat[n - s:]
    if s < BLOCK:
        last[s] ^= 0x80
        last ^= K2
    else:
        last ^= K1
    mac = np.zeros(BLOCK, np.uint8) if init is None else np.asarray(init, np.uint8)
    return cbcmac_np(key, mac, np.concatenate([head, last[None, :]]), device)
