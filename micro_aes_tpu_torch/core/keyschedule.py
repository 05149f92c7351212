"""AES key expansion (FIPS-197 §5.2) as a pure host-side function.

The schedule is tiny (at most 15 blocks) and serial, so it runs in numpy;
the result is a read-only `uint8[rounds+1, 16]`, cached per key.
"""
from __future__ import annotations

import numpy as np

from ..utils.keycache import key_cache
from .sbox import RCON, SBOX

VALID_KEY_SIZES = (16, 24, 32)


def num_rounds(key_len: int) -> int:
    """10/12/14 rounds for AES-128/192/256 (ROUNDS = Nk + 6)."""
    if key_len not in VALID_KEY_SIZES:
        raise ValueError(f"AES key must be 16/24/32 bytes, got {key_len}")
    return key_len // 4 + 6


@key_cache(maxsize=512)
def _expand_cached(key: bytes) -> np.ndarray:
    nk = len(key) // 4
    rounds = nk + 6
    nwords = 4 * (rounds + 1)
    w = np.zeros((nwords, 4), dtype=np.uint8)
    w[:nk] = np.frombuffer(key, dtype=np.uint8).reshape(nk, 4)
    for i in range(nk, nwords):
        t = w[i - 1].copy()
        if i % nk == 0:
            t = SBOX[np.roll(t, -1)]
            t[0] ^= RCON[i // nk]
        elif nk > 6 and i % nk == 4:
            t = SBOX[t]
        w[i] = w[i - nk] ^ t
    rk = w.reshape(rounds + 1, 16)
    rk.setflags(write=False)
    return rk


def expand_key(key) -> np.ndarray:
    """key bytes -> round keys uint8[rounds+1, 16] (cached per key)."""
    key = bytes(key)
    num_rounds(len(key))  # validates the length
    return _expand_cached(key)


def expand_keys_batch(keys: np.ndarray) -> np.ndarray:
    """Vectorized key expansion: uint8[B, klen] -> uint8[B, rounds+1, 16].

    The schedule of `expand_key`, with the word recurrence run over the
    whole batch at once (at most 60 small numpy ops instead of ~60 per
    key): the batch engines see thousands of keys per call."""
    keys = np.asarray(keys, np.uint8)
    b, klen = keys.shape
    nk = klen // 4
    rounds = num_rounds(klen)
    nwords = 4 * (rounds + 1)
    w = np.zeros((nwords, b, 4), dtype=np.uint8)
    w[:nk] = keys.reshape(b, nk, 4).transpose(1, 0, 2)
    for i in range(nk, nwords):
        t = w[i - 1]
        if i % nk == 0:
            t = SBOX[np.roll(t, -1, axis=-1)].copy()
            t[:, 0] ^= RCON[i // nk]
        elif nk > 6 and i % nk == 4:
            t = SBOX[t]
        w[i] = w[i - nk] ^ t
    return np.ascontiguousarray(w.transpose(1, 0, 2).reshape(b, rounds + 1, 16))
