"""Per-message AES-GCM-SIV (RFC 8452), parity with micro_aes.c:1418-1515.

Per-nonce derived keys (GCM_SIVsetup, micro_aes.c:1434-1448), POLYVAL as
the serial fold of ops/mac.ghash_fold with the POLYVAL bit matrix
(ops/gf128.polyval_matrix), and the LE32 counter with bit 7 of byte 15 set
(modes/common's "gcm_siv" convention).  Any AAD and message length; the
nonce is 12 bytes.  Plain PyTorch on the requested device: the JAX package
has no kernel on this path either.  It is the general path and the oracle
of the bulk engine (modes/siv_seal).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.cipher import encrypt_blocks_np
from ..errors import AuthenticationError, DataLengthError
from ..ops.gf128 import polyval_matrix
from ..ops.mac import ghash_fold
from ..utils.bytesio import BLOCK, to_u8, verify_tag
from ..utils.keycache import key_cache
from .common import ctr_xcrypt, enc_block, xmac_blocks

SIVGCM_NONCE_LEN = 12
SIVGCM_TAG_LEN = 16


def _nonce(nonce) -> bytes:
    nonce = bytes(to_u8(nonce))
    if len(nonce) != SIVGCM_NONCE_LEN:  # RFC 8452 fixes the nonce at 96 bits
        raise DataLengthError("GCM-SIV nonce must be exactly 12 bytes")
    return nonce


@key_cache(maxsize=256)
def _derive_keys(key: bytes, nonce: bytes) -> tuple[bytes, bytes]:
    """GCM_SIVsetup: the first halves of E_K(le32(i) || nonce) for i = 0..
    give the auth key (2 halves), then the message key (Nk/2 halves)."""
    count = 2 + len(key) // 8
    blocks = np.zeros((count, BLOCK), np.uint8)
    blocks[:, 4:] = np.frombuffer(nonce, np.uint8)
    blocks[:, 0] = np.arange(count)  # the LE counter fits in byte 0
    halves = encrypt_blocks_np(key, blocks)[:, :8].reshape(-1)
    return bytes(halves[:16]), bytes(halves[16: 16 + len(key)])


@key_cache(maxsize=256)
def _polyval_matrix_cached(auth_key: bytes, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(polyval_matrix(np.frombuffer(auth_key, np.uint8))).to(device)


def _lengths_le(aad_len: int, data_len: int) -> np.ndarray:
    """The POLYVAL length block: both bit lengths little-endian."""
    lens = np.zeros((1, BLOCK), np.uint8)
    lens[0, :8] = np.frombuffer((aad_len * 8).to_bytes(8, "little"), np.uint8)
    lens[0, 8:] = np.frombuffer((data_len * 8).to_bytes(8, "little"), np.uint8)
    return lens


def _polyval(auth_key: bytes, aad, pt, device: torch.device) -> torch.Tensor:
    """POLYVAL of the AAD, the plaintext and the length block -> uint8[16]
    on `device`."""
    aad, pt = to_u8(aad), to_u8(pt)
    blocks = np.concatenate([xmac_blocks(aad), xmac_blocks(pt), _lengths_le(len(aad), len(pt))])
    bt = torch.from_numpy(blocks).to(device)
    return ghash_fold(_polyval_matrix_cached(auth_key, device),
                      torch.zeros(BLOCK, dtype=torch.uint8, device=device), bt, bt.shape[0])


def siv_tag(msg_key: bytes, nonce: bytes, pv: torch.Tensor) -> torch.Tensor:
    """GCM_SIVtag (micro_aes.c:1451-1457): E_msgkey(POLYVAL ^ (nonce || 0)
    with bit 7 of byte 15 cleared) -> uint8[16] on pv's device."""
    x = pv.clone()
    x[:SIVGCM_NONCE_LEN] ^= torch.frombuffer(bytearray(nonce), dtype=torch.uint8).to(pv.device)
    x[15] &= 0x7F
    return enc_block(msg_key, x, pv.device)


def gcm_siv_encrypt(key, nonce, aad, plaintext, *, device="cuda") -> bytes:
    """GCM_SIV_encrypt (micro_aes.c:1470-1483) -> ciphertext || tag."""
    key, nonce, dev = bytes(key), _nonce(nonce), torch.device(device)
    auth_key, msg_key = _derive_keys(key, nonce)
    tag = siv_tag(msg_key, nonce, _polyval(auth_key, aad, plaintext, dev))
    return ctr_xcrypt(msg_key, tag, "gcm_siv", plaintext) + bytes(tag.cpu().numpy())


def gcm_siv_decrypt(key, nonce, aad, ct_and_tag, *, device="cuda") -> bytes:
    """GCM_SIV_decrypt (micro_aes.c:1496-1515): decrypt with the received
    tag, recompute the tag over the plaintext and compare; raises
    AuthenticationError on a mismatch, and no plaintext is returned."""
    key, nonce, dev = bytes(key), _nonce(nonce), torch.device(device)
    data = to_u8(ct_and_tag)
    if len(data) < SIVGCM_TAG_LEN:  # no tag can match, as in the reference
        raise AuthenticationError("GCM-SIV input is shorter than its 16-byte tag")
    ct, tag = data[:-SIVGCM_TAG_LEN], data[-SIVGCM_TAG_LEN:]
    auth_key, msg_key = _derive_keys(key, nonce)
    pt = ctr_xcrypt(msg_key, torch.from_numpy(tag.copy()).to(dev), "gcm_siv", ct)
    if not verify_tag(siv_tag(msg_key, nonce, _polyval(auth_key, aad, pt, dev)), tag):
        raise AuthenticationError("GCM-SIV tag mismatch")
    return pt
