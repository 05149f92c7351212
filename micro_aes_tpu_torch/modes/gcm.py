"""Per-message AES-GCM (NIST SP 800-38D), parity with micro_aes.c:1124-1212.

The CTR body is one batched cipher call over the counter blocks; GHASH is
the serial fold with the per-key bit matrix M_H (ops/mac.ghash_fold).  Any
nonce length (J0 by GHASH when it is not 12 bytes), tags of 1..16 bytes,
and the tag is verified before anything is decrypted (micro_aes.c:
1204-1209).  Plain PyTorch on the requested device: the JAX package has
no kernel on this path.
"""
from __future__ import annotations

import numpy as np
import torch

from ..errors import AuthenticationError
from ..ops.gf128 import ghash_matrix
from ..ops.mac import ghash_fold
from ..utils.bytesio import BLOCK, to_u8, verify_tag
from ..utils.keycache import key_cache
from .common import ctr_xcrypt, enc_block, xmac_blocks

GCM_NONCE_LEN = 12
GCM_TAG_LEN = 16


@key_cache(maxsize=512)
def _auth_matrix(key: bytes, device: torch.device) -> torch.Tensor:
    """M_H for H = E_K(0) (GCMsetup, micro_aes.c:1140-1144) on `device`."""
    h = enc_block(key, bytes(BLOCK), device).cpu().numpy()
    return torch.from_numpy(ghash_matrix(h)).to(device)


def _len_block(aad_len: int, ct_len: int) -> np.ndarray:
    lens = np.zeros((1, BLOCK), np.uint8)
    lens[0, :8] = np.frombuffer((aad_len * 8).to_bytes(8, "big"), np.uint8)
    lens[0, 8:] = np.frombuffer((ct_len * 8).to_bytes(8, "big"), np.uint8)
    return lens


def _ghash(key: bytes, aad, ct, device: torch.device) -> torch.Tensor:
    """gHash (micro_aes.c:1127-1137): fold the AAD, the data, then the
    bit lengths -> uint8[16] on `device`."""
    a, c = to_u8(aad), to_u8(ct)
    blocks = np.concatenate([xmac_blocks(a), xmac_blocks(c), _len_block(len(a), len(c))])
    bt = torch.from_numpy(blocks).to(device)
    return ghash_fold(_auth_matrix(key, device),
                      torch.zeros(BLOCK, dtype=torch.uint8, device=device),
                      bt, bt.shape[0])


def _gcm_iv(key: bytes, nonce, device: torch.device) -> torch.Tensor:
    """J0 (GCMsetup, micro_aes.c:1145-1151): nonce || 0^31 || 1 for a
    12-byte nonce, else GHASH(nonce, lengths)."""
    nonce = to_u8(nonce)
    if len(nonce) == GCM_NONCE_LEN:
        iv = np.zeros(BLOCK, np.uint8)
        iv[:12] = nonce
        iv[15] = 1
        return torch.from_numpy(iv).to(device)
    return _ghash(key, b"", nonce, device)


def _tag(key: bytes, iv: torch.Tensor, aad, ct, tag_len: int) -> bytes:
    g = _ghash(key, aad, ct, iv.device)
    return bytes((enc_block(key, iv, iv.device) ^ g).cpu().numpy())[:tag_len]


def gcm_encrypt(key, nonce, aad, plaintext, tag_len: int = GCM_TAG_LEN, *,
                device="cuda") -> bytes:
    """AES_GCM_encrypt (micro_aes.c:1164-1179) -> ciphertext || tag."""
    key, dev = bytes(key), torch.device(device)
    iv = _gcm_iv(key, nonce, dev)
    ct = ctr_xcrypt(key, iv, "ccm_gcm", plaintext)
    return ct + _tag(key, iv, aad, ct, tag_len)


def gcm_decrypt(key, nonce, aad, ct_and_tag, tag_len: int = GCM_TAG_LEN, *,
                device="cuda") -> bytes:
    """AES_GCM_decrypt (micro_aes.c:1192-1211): the tag is checked first;
    raises AuthenticationError on a mismatch, and nothing is decrypted."""
    key, dev = bytes(key), torch.device(device)
    data = to_u8(ct_and_tag)
    ct, tag = data[: len(data) - tag_len], data[len(data) - tag_len:]
    iv = _gcm_iv(key, nonce, dev)
    if not verify_tag(_tag(key, iv, aad, ct, tag_len), tag):
        raise AuthenticationError("GCM tag mismatch")
    return ctr_xcrypt(key, iv, "ccm_gcm", ct)
