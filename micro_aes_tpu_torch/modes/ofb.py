"""OFB mode, parity with micro_aes.c:852-893.  The keystream is a serial
chain (one K13 launch for the message); the xor is parallel.  Decrypt is
encrypt."""
from __future__ import annotations

from ..utils.bytesio import BLOCK, to_u8
from .common import ofb_keystream_np


def ofb_encrypt(key, iv, plaintext, *, device="cuda") -> bytes:
    data = to_u8(plaintext)
    nblocks = -(-len(data) // BLOCK)
    if nblocks == 0:
        return b""
    ks = ofb_keystream_np(bytes(key), iv, nblocks, device).reshape(-1)[: len(data)]
    return bytes(ks ^ data)


def ofb_decrypt(key, iv, ciphertext, *, device="cuda") -> bytes:
    return ofb_encrypt(key, iv, ciphertext, device=device)
