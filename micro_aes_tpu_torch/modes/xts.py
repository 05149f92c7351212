"""XTS-AES (XEX tweaked codebook with ciphertext stealing), SP 800-38E,
parity with micro_aes.c:998-1093.

The tweak sequence T·α^i is one doubling chain on the host, and the XEX
body is one batched call of the byte cipher on the requested device; only
the two blocks of the stealing tail are handled apart.  Plain PyTorch on
either device: the bulk sector engine (modes/xts_bulk) is the kernel path,
and this module is its oracle.
"""
from __future__ import annotations

import numpy as np

from ..errors import DataLengthError
from ..ops.mac import double_le_np
from ..utils.bytesio import BLOCK, to_u8
from .common import dec_blocks_np, enc_blocks_np


def sector_tweak(sector_id) -> np.ndarray:
    """An integer sector id as the 16-byte tweak block, little-endian
    (copyLint, micro_aes.c:399-404).  Ids outside [0, 2^128) raise
    DataLengthError (a tweak block holds 128 bits)."""
    v = int(sector_id)
    if not 0 <= v < 1 << 128:
        raise DataLengthError(f"XTS sector id {v} is outside [0, 2^128)")
    return np.frombuffer(v.to_bytes(BLOCK, "little"), np.uint8).copy()


def _tweak_chain(t0: np.ndarray, n: int) -> np.ndarray:
    """[T, 2T, 4T, ...] little-endian doublings (micro_aes.c:1035)."""
    out = np.zeros((n, BLOCK), np.uint8)
    t = t0.copy()
    for i in range(n):
        out[i] = t
        t = double_le_np(t)
    return out


def _bit_splice(head: np.ndarray, tail: np.ndarray, b: int) -> np.ndarray:
    """The first b bits of `head` and the last 128-b bits of `tail` (bits
    MSB-first within bytes, the CAVP/IEEE 1619 bit-string order), packed."""
    hb = np.unpackbits(head)
    tb = np.unpackbits(tail)
    return np.packbits(np.concatenate([hb[:b], tb[b:]]))


def _xts_cipher_bits(key1: bytes, encrypt: bool, t0: np.ndarray, data: np.ndarray,
                     bit_len: int, device) -> bytes:
    """Bit-granular XTS-CTS (IEEE 1619 data units whose bit length is not a
    multiple of 8, e.g. the 130-bit CAVP records): the byte path's stealing
    spliced at bit b = bit_len % 128; the final partial block occupies the
    MOST significant bits of its bytes."""
    b = bit_len % 128
    n = bit_len // 128 - 1          # body blocks before the stealing pair
    cipher = enc_blocks_np if encrypt else dec_blocks_np
    tweaks = _tweak_chain(t0, n + 3)

    out_parts = []
    if n > 0:
        body = data[: n * BLOCK].reshape(n, BLOCK)
        tw = tweaks[:n]
        out_parts.append((cipher(key1, body ^ tw, device) ^ tw).reshape(-1))

    tn, tn1 = tweaks[n], tweaks[n + 1]
    t_first, t_second = (tn, tn1) if encrypt else (tn1, tn)
    xn = data[n * BLOCK: (n + 1) * BLOCK]
    cc = cipher(key1, (xn ^ t_first).reshape(1, BLOCK), device)[0] ^ t_first
    partial = np.zeros(BLOCK, np.uint8)
    partial[: len(data) - (n + 1) * BLOCK] = data[(n + 1) * BLOCK:]
    # steal the last 128-b BITS of cc to complete the partial block
    pp = _bit_splice(partial, cc, b)
    final = cipher(key1, (pp ^ t_second).reshape(1, BLOCK), device)[0] ^ t_second
    out_parts.append(final)
    # the partial output is the first b bits of cc, zero-padded
    out_parts.append(np.packbits(np.unpackbits(cc)[:b]))
    return bytes(np.concatenate(out_parts))


def _xts_cipher(keypair: bytes, encrypt: bool, tweak, sector_id: int, data: np.ndarray,
                bit_len: int | None, device) -> bytes:
    klen = len(keypair) // 2
    key1, key2 = keypair[:klen], keypair[klen:]
    r = len(data) % BLOCK
    n = len(data) // BLOCK - (1 if r else 0)

    if tweak is None:
        t0 = sector_tweak(sector_id)
    else:
        t0 = np.zeros(BLOCK, np.uint8)
        t0[:] = to_u8(tweak)[:BLOCK]
    t0 = enc_blocks_np(key2, t0.reshape(1, BLOCK), device)[0]  # T = E_k2(i)

    if bit_len is not None and bit_len % 8:
        return _xts_cipher_bits(key1, encrypt, t0, data, bit_len, device)

    cipher = enc_blocks_np if encrypt else dec_blocks_np
    tweaks = _tweak_chain(t0, n + 2)  # the body and up to 2 tail tweaks

    out_parts = []
    if n:
        body = data[: n * BLOCK].reshape(n, BLOCK)
        tw = tweaks[:n]
        out_parts.append((cipher(key1, body ^ tw, device) ^ tw).reshape(-1))

    if r:
        tn, tn1 = tweaks[n], tweaks[n + 1]
        # encrypt: block n uses T_n and the stolen pass T_{n+1}; decrypt
        # swaps them (micro_aes.c:1041: T = α·L or L = α·T)
        t_first, t_second = (tn, tn1) if encrypt else (tn1, tn)
        xn = data[n * BLOCK: (n + 1) * BLOCK]
        cc = cipher(key1, (xn ^ t_first).reshape(1, BLOCK), device)[0] ^ t_first
        stolen = cc.copy()
        stolen[:r] = data[(n + 1) * BLOCK:]
        final = cipher(key1, (stolen ^ t_second).reshape(1, BLOCK), device)[0] ^ t_second
        out_parts.append(final)
        out_parts.append(cc[:r])

    return bytes(np.concatenate(out_parts)) if out_parts else b""


def _check_bit_len(data: np.ndarray, bit_len: int | None) -> None:
    if len(data) < BLOCK:
        raise DataLengthError("XTS needs at least one full block")
    if bit_len is not None:
        if bit_len < 128 or (bit_len + 7) // 8 != len(data):
            raise DataLengthError(f"bit_len {bit_len} inconsistent with {len(data)} bytes")


def xts_encrypt(keys, tweak, plaintext, sector_id: int = 0, bit_len: int | None = None, *,
                device="cuda") -> bytes:
    """AES_XTS_encrypt (micro_aes.c:1066-1073); keys = key1 || key2.  The
    tweak block is `tweak` (16 bytes) or, when it is None, the integer
    `sector_id` little-endian.  `bit_len` enables bit-granular data units
    (IEEE 1619): the last byte's unused low bits are ignored on input and
    zero on output."""
    data = to_u8(plaintext)
    _check_bit_len(data, bit_len)
    return _xts_cipher(bytes(keys), True, tweak, sector_id, data, bit_len, device)


def xts_decrypt(keys, tweak, ciphertext, sector_id: int = 0, bit_len: int | None = None, *,
                device="cuda") -> bytes:
    """AES_XTS_decrypt (micro_aes.c:1083-1093): the inverse of
    xts_encrypt."""
    data = to_u8(ciphertext)
    _check_bit_len(data, bit_len)
    return _xts_cipher(bytes(keys), False, tweak, sector_id, data, bit_len, device)
