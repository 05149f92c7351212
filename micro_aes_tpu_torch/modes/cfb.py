"""CFB mode (full-block feedback), parity with micro_aes.c:789-846.

Encrypt chains serially: one K13 launch over the zero-padded message.  Decrypt
is parallel, P_i = E(C_{i-1}) ^ C_i with C_{-1} = IV: one batched call of
the byte cipher.
"""
from __future__ import annotations

import numpy as np

from ..utils.bytesio import BLOCK, to_blocks, to_u8
from .common import chain_np, enc_blocks_np


def cfb_encrypt(key, iv, plaintext, *, device="cuda") -> bytes:
    data = to_u8(plaintext)
    if not len(data):
        return b""
    # the chain over the zero-padded message: the last step of a ragged tail
    # is E(C_{n-1}) ^ (tail || 0), whose first bytes are the tail's ciphertext
    ys = chain_np("cfb", bytes(key), iv, to_blocks(data), device)
    return bytes(ys.reshape(-1)[: len(data)])


def cfb_decrypt(key, iv, ciphertext, *, device="cuda") -> bytes:
    data = to_u8(ciphertext)
    nin = -(-len(data) // BLOCK)
    if nin == 0:
        return b""
    # the cipher's inputs: IV, C_0, ..., C_{nin-2}
    ins = np.zeros((nin, BLOCK), np.uint8)
    ins[0] = to_u8(iv)[:BLOCK]
    ins[1:] = data[: (nin - 1) * BLOCK].reshape(nin - 1, BLOCK)
    ks = enc_blocks_np(bytes(key), ins, device).reshape(-1)[: len(data)]
    return bytes(ks ^ data)
