"""CTR mode (no authentication), parity with micro_aes.c:953-990.

The counter blocks are a function of the block index alone (ops/counter),
so the keystream is one batched cipher call on the requested device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.bytesio import BLOCK, to_u8
from .common import ctr_xcrypt

CTR_IV_LENGTH = 12
CTR_START_VALUE = 1  # RFC-3686 recommendation (micro_aes.h:97-99)


def ctr_encrypt(key, iv, plaintext, preset_counter: bool = False, *,
                device="cuda") -> bytes:
    """AES_CTR_encrypt (micro_aes.c:962-976).  By default iv is a 12-byte
    nonce and the big-endian counter starts at CTR_START_VALUE;
    preset_counter=True takes iv as the whole 16-byte initial counter block
    (the PRESET_COUNTER macro, micro_aes.h:100)."""
    ivb = to_u8(iv)
    base = np.zeros(BLOCK, np.uint8)
    if preset_counter:
        base[:] = ivb[:BLOCK]
    else:
        base[:CTR_IV_LENGTH] = ivb[:CTR_IV_LENGTH]
        base[BLOCK - 1] ^= CTR_START_VALUE
    return ctr_xcrypt(bytes(key), torch.from_numpy(base).to(device), "ctr", plaintext)


def ctr_decrypt(key, iv, ciphertext, preset_counter: bool = False, *,
                device="cuda") -> bytes:
    """AES_CTR_decrypt: the same keystream xor as ctr_encrypt."""
    return ctr_encrypt(key, iv, ciphertext, preset_counter, device=device)
