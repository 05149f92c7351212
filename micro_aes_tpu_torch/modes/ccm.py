"""AES-CCM (NIST SP 800-38C / RFC 3610), parity with micro_aes.c:1219-1314.

The CTR body is one batched cipher call on the requested device; the CBC-MAC
over B0 | AAD | payload is serial, one K13 launch for the message
(common.cbcmac_np).  Decrypt-then-verify, as the reference orders it
(micro_aes.c:1304-1312).  The batch engine (modes/bulk.ccm_*_batch, on K11)
is held against this module.
"""
from __future__ import annotations

import numpy as np
import torch

from ..errors import AuthenticationError
from ..utils.bytesio import BLOCK, to_u8, verify_tag
from .common import cbcmac_np, ctr_xcrypt, enc_block, xmac_blocks

CCM_NONCE_LEN = 11
CCM_TAG_LEN = 16


def _ccm_tag(key: bytes, iv0: np.ndarray, aad: np.ndarray, pt: np.ndarray, tag_len: int,
             device) -> np.ndarray:
    """CCMtag (micro_aes.c:1222-1256): B0 with the flags and the BE payload
    length, the A-segment (a 2-byte length field, 6 bytes with the 0xFFFE
    prefix past 0xFEFF), the payload, then E(A0) ^ CBC-MAC."""
    m = iv0.copy()
    m[0] |= (tag_len - 2) << 2
    v, i = len(pt), 15
    while True:  # xorBEint(M, ptextLen, LAST), c:410-416
        m[i] ^= v & 0xFF
        v >>= 8
        i -= 1
        if not v:
            break
    alen = len(aad)
    segments = []
    if alen:
        m[0] |= 0x40
        m = enc_block(key, m, device).cpu().numpy()
        a = np.zeros(BLOCK, np.uint8)
        p = 1
        if alen > 0xFEFF:
            p += 4
            a[0], a[1] = 0xFF, 0xFE
        v, i = alen, p
        while True:
            a[i] ^= v & 0xFF
            v >>= 8
            i -= 1
            if not v:
                break
        p += 1
        s = BLOCK - p
        a[p: p + min(alen, s)] = aad[:s]
        segments.append(a[None, :])
        if alen > s:
            segments.append(xmac_blocks(aad[s:]))
    else:
        segments.append(np.zeros((1, BLOCK), np.uint8))  # xMac of a zero A block
    segments.append(xmac_blocks(pt))
    m = cbcmac_np(key, m, np.concatenate(segments), device)
    return enc_block(key, iv0, device).cpu().numpy() ^ m  # c:1254-1255


def _iv0(nonce) -> np.ndarray:
    """A0: the flags byte L - 1 = 14 - len(nonce), then the nonce
    (micro_aes.c:1273)."""
    nonce = to_u8(nonce)
    iv = np.zeros(BLOCK, np.uint8)
    iv[0] = 14 - len(nonce)
    iv[1: 1 + len(nonce)] = nonce
    return iv


def ccm_encrypt(key, nonce, aad, plaintext, nonce_len: int = CCM_NONCE_LEN,
                tag_len: int = CCM_TAG_LEN, *, device="cuda") -> bytes:
    """AES_CCM_encrypt (micro_aes.c:1268-1282) -> ct || tag."""
    key = bytes(key)
    pt, aad = to_u8(plaintext), to_u8(aad)
    iv0 = _iv0(to_u8(nonce)[:nonce_len])
    tag = _ccm_tag(key, iv0, aad, pt, tag_len, device)
    ct = ctr_xcrypt(key, torch.from_numpy(iv0).to(device), "ccm_gcm", pt)
    return ct + bytes(tag[:tag_len])


def ccm_decrypt(key, nonce, aad, ct_and_tag, nonce_len: int = CCM_NONCE_LEN,
                tag_len: int = CCM_TAG_LEN, *, device="cuda") -> bytes:
    """AES_CCM_decrypt (micro_aes.c:1295-1314): decrypt, then verify;
    AuthenticationError on a mismatch."""
    key = bytes(key)
    data = to_u8(ct_and_tag)
    ct, tag = data[: len(data) - tag_len], data[len(data) - tag_len:]
    iv0 = _iv0(to_u8(nonce)[:nonce_len])
    pt = to_u8(ctr_xcrypt(key, torch.from_numpy(iv0).to(device), "ccm_gcm", ct))
    expect = _ccm_tag(key, iv0, to_u8(aad), pt, tag_len, device)[:tag_len]
    if not verify_tag(expect, tag):
        raise AuthenticationError("CCM tag mismatch")
    return bytes(pt)
