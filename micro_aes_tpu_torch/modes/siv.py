"""AES-SIV (RFC 5297), parity with micro_aes.c:1321-1410.

S2V is the CMAC* construction with doubling and xorend (its CMACs are K13
folds, common.cmac_digest); the CTR body counts from the synthetic IV with
bit 7 of bytes 8 and 12 cleared (micro_aes.c:931-934), one batched cipher
call on the requested device.  Keys are K1 (MAC) || K2 (CTR).  The batch
engine (modes/bulk.siv_*_batch, on K12) is held against this module.
"""
from __future__ import annotations

import numpy as np
import torch

from ..errors import AuthenticationError, DataLengthError
from ..ops.mac import double_be_np
from ..utils.bytesio import BLOCK, to_u8, verify_tag
from .common import cmac_digest, ctr_xcrypt


def _s2v(key1: bytes, aad, pt, device) -> np.ndarray:
    """S2V (micro_aes.c:1324-1360), the single-AAD form of the reference."""
    aad, pt = to_u8(aad), to_u8(pt)
    y = cmac_digest(key1, bytes(BLOCK), device)  # Y0 = CMAC(zero block)
    if len(aad):
        y = double_be_np(y) ^ cmac_digest(key1, aad, device)
    if len(pt) < BLOCK:
        pad = np.zeros(BLOCK, np.uint8)
        pad[: len(pt)] = pt
        pad[len(pt)] = 0x80
        return cmac_digest(key1, double_be_np(y) ^ pad, device)
    data = pt.copy()
    data[-BLOCK:] ^= y  # xorend
    return cmac_digest(key1, data, device)


def _split(keys) -> tuple[bytes, bytes]:
    keys = bytes(keys)
    return keys[: len(keys) // 2], keys[len(keys) // 2:]


def _ctr(key2: bytes, iv: np.ndarray, data, device) -> bytes:
    return ctr_xcrypt(key2, torch.from_numpy(np.array(iv, np.uint8)).to(device), "siv", data)


def siv_encrypt(keys, aad, plaintext, *, device="cuda") -> tuple[bytes, bytes]:
    """AES_SIV_encrypt (micro_aes.c:1372-1381) -> (iv, ct)."""
    k1, k2 = _split(keys)
    iv = _s2v(k1, aad, plaintext, device)
    return bytes(iv), _ctr(k2, iv, plaintext, device)


def siv_decrypt(keys, iv, aad, ciphertext, *, device="cuda") -> bytes:
    """AES_SIV_decrypt (micro_aes.c:1394-1410): decrypt, synthesize the IV
    again and compare; AuthenticationError on a mismatch."""
    k1, k2 = _split(keys)
    iv, ct = to_u8(iv)[:BLOCK], to_u8(ciphertext)
    if len(iv) < BLOCK and len(ct):
        raise DataLengthError(f"the IV has {len(iv)} bytes; it needs {BLOCK}")
    # an empty message needs no counter; a short IV then fails the compare
    pt = _ctr(k2, iv, ct, device) if len(ct) else b""
    if not verify_tag(_s2v(k1, aad, pt, device), iv):
        raise AuthenticationError("SIV verification failed")
    return pt
