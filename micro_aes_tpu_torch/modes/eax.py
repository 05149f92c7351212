"""AES-EAX and EAX' (ANSI C12.22 / IEEE Std 1703), parity with
micro_aes.c:1522-1647.

EAX: tag = OMAC(0; nonce) ^ OMAC(1; aad) ^ OMAC(2; ct), CTR from OMAC(0).
EAX': little-endian doubling subkeys, the nonce data doubling as the AAD, a
4-byte tag, and the N' bit clearing of bytes 12 and 14 (c:1579-1583).
The OMACs are CMAC folds (one K13 launch each, common.cmac_digest), the
CTR body one batched cipher call on the requested device.  The EAX batch
engine (modes/bulk.eax_*_batch, on K11) is held against this module.
"""
from __future__ import annotations

import numpy as np
import torch

from ..errors import AuthenticationError
from ..utils.bytesio import BLOCK, to_u8, verify_tag
from .common import cmac_digest, cmac_subkeys, ctr_xcrypt, enc_block

EAX_TAG_LEN = 16
EAXP_TAG_LEN = 4


def _omac(key: bytes, t: int, data, device) -> np.ndarray:
    """oMac, the EAX flavour (micro_aes.c:1531-1549): the CMAC of the block
    [0..0, t] || data; of [0..0, t] ^ K1 alone for empty data."""
    data = to_u8(data)
    k1, _ = cmac_subkeys(key, device)
    init = np.zeros(BLOCK, np.uint8) if len(data) else k1.copy()
    init[BLOCK - 1] ^= t
    init = enc_block(key, init, device).cpu().numpy()
    if not len(data):
        return init
    return cmac_digest(key, data, device, init=init)


def _ctr(key: bytes, base: np.ndarray, data, device) -> bytes:
    return ctr_xcrypt(key, torch.from_numpy(np.array(base, np.uint8)).to(device), "ctr", data)


def eax_encrypt(key, nonce, aad, plaintext, tag_len: int = EAX_TAG_LEN, *,
                device="cuda") -> bytes:
    """AES_EAX_encrypt (micro_aes.c:1563-1597) -> ct || tag."""
    key = bytes(key)
    n_mac = _omac(key, 0, nonce, device)
    ct = _ctr(key, n_mac, plaintext, device)
    tag = n_mac ^ _omac(key, 1, aad, device) ^ _omac(key, 2, ct, device)
    return ct + bytes(tag[:tag_len])


def eax_decrypt(key, nonce, aad, ct_and_tag, tag_len: int = EAX_TAG_LEN, *,
                device="cuda") -> bytes:
    """AES_EAX_decrypt (micro_aes.c:1611-1647): verify, then decrypt;
    AuthenticationError on a mismatch."""
    key = bytes(key)
    data = to_u8(ct_and_tag)
    ct, tag = data[: len(data) - tag_len], data[len(data) - tag_len:]
    n_mac = _omac(key, 0, nonce, device)
    expect = (n_mac ^ _omac(key, 1, aad, device) ^ _omac(key, 2, ct, device))[:tag_len]
    if not verify_tag(expect, tag):
        raise AuthenticationError("EAX tag mismatch")
    return _ctr(key, n_mac, ct, device)


def _omac_p(key: bytes, t: int, data, device) -> np.ndarray:
    """oMac, the EAX' flavour (micro_aes.c:1534-1540): CMAC' with the
    little-endian subkeys from init K1 (t = 0) or K2; an empty ciphertext
    gives zeros ("ignore null ciphertext")."""
    data = to_u8(data)
    subkeys = cmac_subkeys(key, device, little_endian=True)
    if not len(data) and t:
        return np.zeros(BLOCK, np.uint8)
    init = subkeys[1 if t else 0].copy()
    return cmac_digest(key, data, device, init=init, subkeys=subkeys)


def _eaxp_base(n: np.ndarray) -> np.ndarray:
    """N' with bit 7 of bytes 12 and 14 cleared (c:1580-1583): the CTR base."""
    base = n.copy()
    base[12] &= 0x7F
    base[14] &= 0x7F
    return base


def eaxp_encrypt(key, nonce_data, plaintext, *, device="cuda") -> bytes:
    """EAX' encrypt (the EAXP=1 build): nonce_data doubles as the AAD ->
    ct || 4-byte mac."""
    key = bytes(key)
    n = _omac_p(key, 0, nonce_data, device)
    ct = _ctr(key, _eaxp_base(n), plaintext, device)
    tag = n[12:16] ^ _omac_p(key, 2, ct, device)[12:16]
    return ct + bytes(tag)


def eaxp_decrypt(key, nonce_data, ct_and_tag, *, device="cuda") -> bytes:
    """EAX' decrypt: the 4-byte mac is checked, then CTR (c:1611-1646);
    AuthenticationError on a mismatch."""
    key = bytes(key)
    data = to_u8(ct_and_tag)
    ct, tag = data[: len(data) - EAXP_TAG_LEN], data[len(data) - EAXP_TAG_LEN:]
    n = _omac_p(key, 0, nonce_data, device)
    if not verify_tag(_omac_p(key, 2, ct, device)[12:16] ^ n[12:16], tag):
        raise AuthenticationError("EAX' mac mismatch")
    return _ctr(key, _eaxp_base(n), ct, device)
