"""ECB mode (NIST SP 800-38A), parity with micro_aes.c:628-681.

Block-parallel: the whole message is one batched call of the byte cipher on
the requested device.
"""
from __future__ import annotations

from ..errors import DecryptionError
from ..utils.bytesio import BLOCK, to_u8
from .common import PAD_ZERO, dec_blocks_np, enc_blocks_np, pad_message


def ecb_encrypt(key, plaintext, padding: int = PAD_ZERO, *, device="cuda") -> bytes:
    """AES_ECB_encrypt (micro_aes.c:636-653); `padding` mirrors AES_PADDING."""
    padded, _ = pad_message(to_u8(plaintext), padding)
    return bytes(enc_blocks_np(bytes(key), padded.reshape(-1, BLOCK), device).reshape(-1))


def ecb_decrypt(key, ciphertext, *, device="cuda") -> bytes:
    """AES_ECB_decrypt (micro_aes.c:663-680): every block decrypted, the
    padding left in place as the reference does; a partial block raises
    DecryptionError."""
    data = to_u8(ciphertext)
    if len(data) % BLOCK:
        raise DecryptionError("ciphertext has a partial block")
    return bytes(dec_blocks_np(bytes(key), data.reshape(-1, BLOCK), device).reshape(-1))
