"""Plain XTS-AES (IEEE 1619-2007) over whole data units in PyTorch.

A data unit (a disk sector) of J blocks under key1 || key2 and its
128-bit unit number i (dm-crypt's plain64: the sector number,
little-endian): T = E_key2(i), then block j is C_j = E_key1(P_j ^ T_j) ^
T_j with T_j = T * alpha^j, alpha^j by j doublings of the little-endian
128-bit value reduced by x^128 + x^7 + x^2 + x + 1 (§5.2).  Whole blocks
only: a sector is a multiple of 16 bytes.
"""
from __future__ import annotations

import numpy as np
import torch

from . import aes

BLOCK = aes.BLOCK


def _double(t: torch.Tensor) -> torch.Tensor:
    """t * alpha for little-endian uint8[..., 16] values."""
    carry = torch.cat([torch.zeros_like(t[..., :1]), t[..., :-1] >> 7], -1)
    out = (t << 1) | carry
    out[..., 0] ^= (t[..., 15] >> 7) * 0x87
    return out


def unit_tweaks(sector_ids) -> np.ndarray:
    """uint8[S, 16]: each unit number as a 128-bit little-endian value."""
    ids = np.asarray(sector_ids, np.uint64)
    out = np.zeros((len(ids), BLOCK), np.uint8)
    out[:, :8] = ids.astype("<u8").view(np.uint8).reshape(-1, 8)
    return out


def xts(keys: bytes, sector_ids, data, sector_size: int, decrypt: bool, *,
        device="cpu") -> bytes:
    """Encrypt (or decrypt) whole sectors, sector s under unit number
    sector_ids[s]; keys = key1 || key2 of one AES size."""
    keys = bytes(keys)
    half = len(keys) // 2
    j = sector_size // BLOCK
    flat = np.frombuffer(bytes(data), np.uint8)
    s = len(flat) // sector_size
    if sector_size % BLOCK or len(flat) != s * sector_size or len(sector_ids) != s:
        raise ValueError("whole 16-byte-aligned sectors, one unit number each")
    rk1 = aes.round_keys([keys[:half]], device)[0]
    rk2 = aes.round_keys([keys[half:]], device)[0]
    t = aes.encrypt(rk2, torch.from_numpy(unit_tweaks(sector_ids)).to(device))
    tw = [t]
    for _ in range(j - 1):
        tw.append(_double(tw[-1]))
    tw = torch.stack(tw, 1)  # [S, J, 16]
    x = torch.from_numpy(flat.reshape(s, j, BLOCK).copy()).to(device)
    y = (aes.decrypt if decrypt else aes.encrypt)(rk1, x ^ tw) ^ tw
    return y.cpu().numpy().tobytes()
