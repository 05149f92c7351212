"""FPE front end, parity with FPE_cipher / AES_FPE_* (micro_aes.c:2254-2348).

Methods: "ff1" (default, FF_X=1), "ff3-1" (FF_X=3 with a 7-byte tweak),
and the withdrawn "ff3" (8-byte tweak), which the reference's test vectors
also cover.  One token per call here, on the host with its block cipher
work on `device`; fpe/device.py runs batches of tokens on the device.
"""
from __future__ import annotations

from ..errors import DecryptionError, EncryptionError
from .alphabet import ALPHABETS, Alphabet, resolve_alphabet
from .ff1 import ff1_cipher
from .ff3 import ff3_cipher


def _fpe(key, tweak, text, alphabet, method: str, encrypt: bool, device) -> str:
    alpha = resolve_alphabet(alphabet)
    method = method.lower()
    err = EncryptionError if encrypt else DecryptionError
    if len(text) < alpha.min_len:
        raise err(f"input shorter than MINLEN={alpha.min_len}")
    if method in ("ff3", "ff3-1") and len(text) > alpha.max_len_ff3():
        raise err(f"input longer than MAXLEN={alpha.max_len_ff3()}")
    try:
        digits = alpha.encode(str(text))
    except EncryptionError:
        raise err("invalid character for alphabet")
    key = bytes(key)
    tweak = bytes(tweak) if tweak else b""
    if method == "ff1":
        out = ff1_cipher(key, tweak, digits, alpha.radix, encrypt, device)
    elif method in ("ff3", "ff3-1"):
        out = ff3_cipher(key, tweak, digits, alpha.radix, encrypt, device)
    else:
        raise ValueError(f"unknown FPE method {method!r}")
    return alpha.decode(out)


def fpe_encrypt(key, tweak, plaintext: str, alphabet="digits", method: str = "ff1", *,
                device="cuda") -> str:
    """AES_FPE_encrypt (micro_aes.c:2326-2331)."""
    return _fpe(key, tweak, plaintext, alphabet, method, True, device)


def fpe_decrypt(key, tweak, ciphertext: str, alphabet="digits", method: str = "ff1", *,
                device="cuda") -> str:
    """AES_FPE_decrypt (micro_aes.c:2343-2348)."""
    return _fpe(key, tweak, ciphertext, alphabet, method, False, device)


__all__ = ["fpe_encrypt", "fpe_decrypt", "Alphabet", "ALPHABETS",
           "resolve_alphabet"]
