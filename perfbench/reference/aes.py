"""Plain AES (FIPS-197) in PyTorch: the benchmark's own reference cipher.

Byte-oriented, table-driven and written from the standard alone: the S-box
is derived from the GF(2^8) inverse and the affine map (FIPS-197 §5.1.1),
the round keys from §5.2.  It runs on any torch device, many blocks at once,
each block under its own key where the round keys broadcast against the
blocks.  It shares no code with the program under test.
"""
from __future__ import annotations

import numpy as np
import torch

BLOCK = 16
ROUNDS = {16: 10, 24: 12, 32: 14}


def _gmul(a: int, b: int) -> int:
    """a * b in GF(2^8) modulo x^8 + x^4 + x^3 + x + 1."""
    out = 0
    while b:
        if b & 1:
            out ^= a
        a = ((a << 1) ^ (0x11B if a & 0x80 else 0)) & 0xFF
        b >>= 1
    return out


def _sbox() -> np.ndarray:
    inv = [0] * 256
    for a in range(1, 256):
        for b in range(1, 256):
            if _gmul(a, b) == 1:
                inv[a] = b
                break
    out = np.zeros(256, np.uint8)
    for x in range(256):
        b = inv[x]
        s = b
        for shift in (1, 2, 3, 4):
            s ^= ((b << shift) | (b >> (8 - shift))) & 0xFF
        out[x] = s ^ 0x63
    return out


SBOX = _sbox()
INV_SBOX = np.argsort(SBOX).astype(np.uint8)
_MUL = {m: np.array([_gmul(x, m) for x in range(256)], np.uint8) for m in (2, 3, 9, 11, 13, 14)}
# ShiftRows on the column-major state (byte r + 4c is row r, column c):
# out[r + 4c] = in[r + 4((c + r) % 4)]
SHIFT_ROWS = [r + 4 * ((c + r) % 4) for c in range(4) for r in range(4)]
INV_SHIFT_ROWS = [SHIFT_ROWS.index(i) for i in range(16)]


def expand_keys(keys: np.ndarray) -> np.ndarray:
    """uint8[B, Nk*4] cipher keys of one size -> uint8[B, R+1, 16] round
    keys (FIPS-197 §5.2), vectorised over the batch."""
    keys = np.asarray(keys, np.uint8)
    b, klen = keys.shape
    nk, rounds = klen // 4, ROUNDS[klen]
    w = np.zeros((b, 4 * (rounds + 1), 4), np.uint8)
    w[:, :nk] = keys.reshape(b, nk, 4)
    rcon = 1
    for i in range(nk, 4 * (rounds + 1)):
        t = w[:, i - 1].copy()
        if i % nk == 0:
            t = SBOX[np.roll(t, -1, axis=1)]
            t[:, 0] ^= rcon
            rcon = _gmul(rcon, 2)
        elif nk > 6 and i % nk == 4:
            t = SBOX[t]
        w[:, i] = w[:, i - nk] ^ t
    return w.reshape(b, rounds + 1, 16)


class Tables:
    """The cipher's byte tables on one device."""

    def __init__(self, device):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        self.sbox, self.inv_sbox = t(SBOX), t(INV_SBOX)
        self.mul = {m: t(v) for m, v in _MUL.items()}
        self.shift = torch.tensor(SHIFT_ROWS, device=device)
        self.inv_shift = torch.tensor(INV_SHIFT_ROWS, device=device)


_TABLES: dict = {}


def tables(device) -> Tables:
    device = torch.device(device)
    if device not in _TABLES:
        _TABLES[device] = Tables(device)
    return _TABLES[device]


def _lookup(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return table[x.long()]


def _mix(t: Tables, x: torch.Tensor, coeffs) -> torch.Tensor:
    """MixColumns (coeffs 2, 3, 1, 1) or InvMixColumns (14, 11, 13, 9): row r
    of a column takes sum_k coeffs[k] * a[r + k]."""
    a = x.reshape(*x.shape[:-1], 4, 4)
    out = None
    for k, m in enumerate(coeffs):
        term = torch.roll(a, -k, dims=-1)
        if m != 1:
            term = _lookup(t.mul[m], term)
        out = term if out is None else out ^ term
    return out.reshape(x.shape)


def encrypt(round_keys: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """E_k of uint8[..., 16] blocks; round_keys uint8[..., R+1, 16] broadcast
    against the blocks' leading dimensions once the round axis is taken."""
    t = tables(blocks.device)
    rounds = round_keys.shape[-2] - 1
    x = blocks ^ round_keys[..., 0, :]
    for r in range(1, rounds + 1):
        x = _lookup(t.sbox, x)[..., t.shift]
        if r < rounds:
            x = _mix(t, x, (2, 3, 1, 1))
        x = x ^ round_keys[..., r, :]
    return x


def decrypt(round_keys: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """D_k, the inverse of encrypt (FIPS-197 §5.3)."""
    t = tables(blocks.device)
    rounds = round_keys.shape[-2] - 1
    x = blocks ^ round_keys[..., rounds, :]
    for r in range(rounds - 1, -1, -1):
        x = _lookup(t.inv_sbox, x[..., t.inv_shift])
        x = x ^ round_keys[..., r, :]
        if r > 0:
            x = _mix(t, x, (14, 11, 13, 9))
    return x


def round_keys(keys, device) -> torch.Tensor:
    """Round keys of a list of keys of one size (bytes), on `device`."""
    arr = np.frombuffer(b"".join(bytes(k) for k in keys), np.uint8).reshape(len(keys), -1)
    return torch.from_numpy(expand_keys(arr)).to(device)
