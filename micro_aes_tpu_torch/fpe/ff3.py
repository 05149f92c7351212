"""FF3 / FF3-1 format-preserving encryption (NIST SP 800-38G §5.2, and the
FF3-1 revision), parity with FF3_cipher/FF3round (micro_aes.c:2205-2248),
including the reversed-key convention (c:2233).

FF3 uses an 8-byte tweak (the withdrawn original); FF3-1 uses 7 bytes
(FF3_TWEAK_LEN, micro_aes.h:93-95).  Both share the 8-round Feistel.  Each
round's block is encrypted on the request's device by the byte cipher; the
radix arithmetic uses exact Python ints on the host.
"""
from __future__ import annotations

import numpy as np

from ..errors import DataLengthError
from ..modes.common import enc_block
from .ff1 import _num, _str


def _split_tweak(tweak: bytes) -> tuple[bytes, bytes]:
    if len(tweak) == 8:  # original FF3
        return tweak[:4], tweak[4:]
    if len(tweak) == 7:  # FF3-1: 56-bit tweak split (spec §5.2 rev.)
        tl = tweak[:3] + bytes([tweak[3] & 0xF0])
        tr = tweak[4:7] + bytes([(tweak[3] & 0x0F) << 4])
        return tl, tr
    raise DataLengthError("FF3 tweak must be 7 (FF3-1) or 8 (FF3) bytes")


def ff3_cipher(key: bytes, tweak: bytes, digits: list[int], radix: int,
               encrypt: bool, device) -> list[int]:
    tl, tr = _split_tweak(bytes(tweak))
    rev_key = bytes(reversed(key))
    n = len(digits)
    u = (n + 1) // 2  # ceil
    v = n - u
    a, b = digits[:u], digits[u:]

    def round_f(i: int, src: list[int]) -> int:
        w = tr if i % 2 == 0 else tl
        p = bytes(x ^ y for x, y in zip(w, bytes([0, 0, 0, i])))
        p += _num(list(reversed(src)), radix).to_bytes(12, "big")
        s = enc_block(rev_key, np.frombuffer(p[::-1], np.uint8), device)
        return int.from_bytes(bytes(s.cpu().numpy()[::-1]), "big")

    if encrypt:
        for i in range(8):
            m = u if i % 2 == 0 else v
            y = round_f(i, b)
            c = (_num(list(reversed(a)), radix) + y) % radix**m
            a, b = b, list(reversed(_str(c, radix, m)))
    else:
        for i in range(7, -1, -1):
            m = u if i % 2 == 0 else v
            y = round_f(i, a)
            c = (_num(list(reversed(b)), radix) - y) % radix**m
            a, b = list(reversed(_str(c, radix, m))), a
    return a + b
