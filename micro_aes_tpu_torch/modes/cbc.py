"""CBC mode with optional CS3 ciphertext stealing, parity with
micro_aes.c:687-783.

Encrypt is a strict serial chain: one K13 launch for the message (the
stolen block of CTS is one more chain step, E(C_{n-1} ^ padded tail)).
Decrypt is block-parallel (P_i = D(C_i) ^ C_{i-1}): one batched call of the
byte cipher, and a second one-block call for the stealing tail.
"""
from __future__ import annotations

import numpy as np

from ..errors import DataLengthError
from ..utils.bytesio import BLOCK, to_u8
from .common import PAD_ZERO, chain_np, dec_blocks_np, iv_block, pad_message


def _cts_split(nbytes: int) -> tuple[int, int]:
    """(whole blocks chained normally, tail bytes) under CS3: a whole-block
    message of two or more blocks still swaps its last two."""
    n, r = divmod(nbytes, BLOCK)
    if n > 1 and r == 0:
        n, r = n - 1, BLOCK
    if n == 0:
        raise DataLengthError("CBC-CTS needs at least one full block")
    return n, r


def cbc_encrypt(key, iv, plaintext, cts: bool = True, padding: int = PAD_ZERO, *,
                device="cuda") -> bytes:
    """AES_CBC_encrypt (micro_aes.c:697-735).  cts=True is the reference's
    compiled default (the CTS macro, CS3 unconditional swap)."""
    key, data = bytes(key), to_u8(plaintext)
    if not cts:
        padded, _ = pad_message(data, padding)
        if not len(padded):
            return b""
        return bytes(chain_np("cbc", key, iv, padded.reshape(-1, BLOCK), device).reshape(-1))
    n, r = _cts_split(len(data))
    blocks = np.zeros((n + (1 if r else 0), BLOCK), np.uint8)
    blocks.reshape(-1)[: len(data)] = data
    c = chain_np("cbc", key, iv, blocks, device)
    if r == 0:
        return bytes(c.reshape(-1))
    # CS3 swap (micro_aes.c:718-732): the stolen block replaces C_{n-1}, and
    # the first r bytes of C_{n-1} become the final chunk
    return bytes(np.concatenate([c[: n - 1].reshape(-1), c[n], c[n - 1][:r]]))


def cbc_decrypt(key, iv, ciphertext, cts: bool = True, *, device="cuda") -> bytes:
    """AES_CBC_decrypt (micro_aes.c:746-782).  Block-parallel."""
    key, data = bytes(key), to_u8(ciphertext)
    iv = iv_block(iv)
    if cts:
        n, r = _cts_split(len(data))
    else:
        n, r = divmod(len(data), BLOCK)
        if r:
            raise DataLengthError("ciphertext must be a block multiple")
    if r == 0:
        blocks = data.reshape(n, BLOCK)
        if not n:
            return b""
        prev = np.concatenate([iv[None, :], blocks[:-1]])
        return bytes((dec_blocks_np(key, blocks, device) ^ prev).reshape(-1))
    # CTS tail: the last two chunks are X (whole) and Z (r bytes)
    # (micro_aes.c:771-778); the m blocks before them decrypt normally
    m = n - 1
    head = data[: m * BLOCK].reshape(m, BLOCK)
    x = data[m * BLOCK: n * BLOCK]
    z = data[n * BLOCK:]
    dx = dec_blocks_np(key, x.reshape(1, BLOCK), device)[0]
    y = dx.copy()
    y[:r] = z
    prev_iv = head[-1] if m else iv
    p_prev = dec_blocks_np(key, y.reshape(1, BLOCK), device)[0] ^ prev_iv
    body = np.zeros(0, np.uint8)
    if m:
        prevs = np.concatenate([iv[None, :], head[:-1]])
        body = (dec_blocks_np(key, head, device) ^ prevs).reshape(-1)
    return bytes(np.concatenate([body, p_prev, dx[:r] ^ z]))
