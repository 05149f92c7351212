"""GF(2^128) algebra for GHASH and POLYVAL: bit conversions, the bit-serial
multiply oracle, and multiplication by a fixed H as a 128x128 GF(2)
bit-matrix (`ghash_matrix`, and `polyval_matrix` for GCM-SIV: the bulk
machinery of ops/ghash_bulk serves both, the convention lives in the
matrix).

A multiplication by a *fixed* operand H is a GF(2)-linear map of the 128
input bits, so it is materialized once per key as `M_H` by probing the
bit-serial routine with unit vectors; applying it is then a matrix product
and a parity.  H^k chains become matrix powers.

Bit order: bit index 8*i + j of a block is (byte_i >> (7-j)) & 1
(big-endian within bytes).  All conversions go through blocks_to_bits /
bits_to_blocks.
"""
from __future__ import annotations

import numpy as np
import torch

_MSB_FIRST = (7, 6, 5, 4, 3, 2, 1, 0)


def _shifts(device) -> torch.Tensor:
    return torch.tensor(_MSB_FIRST, dtype=torch.uint8, device=device)


def blocks_to_bits(blocks: torch.Tensor) -> torch.Tensor:
    """uint8[..., 16] -> uint8[..., 128] of 0/1 bits, MSB-first per byte."""
    b = (blocks[..., :, None] >> _shifts(blocks.device)) & 1
    return b.reshape(blocks.shape[:-1] + (128,))


def bits_to_blocks(bits: torch.Tensor) -> torch.Tensor:
    """0/1 [..., 128] -> uint8[..., 16]."""
    b = bits.reshape(bits.shape[:-1] + (16, 8)).to(torch.uint8)
    return (b << _shifts(bits.device)).sum(dim=-1, dtype=torch.uint8)


def halve_be(x: torch.Tensor) -> torch.Tensor:
    """divideBblock (micro_aes.c:464-473): BE shift right by one bit; if
    the dropped LSB was set, the first byte takes ^= 0xE1."""
    carry_in = torch.cat([torch.zeros_like(x[..., :1]),
                          (x[..., :-1] & 1) << 7], dim=-1)
    y = (x >> 1) | carry_in
    lsb_out = x[..., 15] & 1
    y = y.clone()
    y[..., 0] ^= lsb_out * 0xE1
    return y


def mul_gf128(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """GHASH-convention product (micro_aes.c:476-493), bit-serial over 128
    steps: the independent oracle.  `x` may be one block [16] or batched
    [..., 16] matching the leading axes of `y`; uint8 on any device."""
    xbits = blocks_to_bits(x)
    acc = torch.zeros_like(y)
    yy = y
    for i in range(128):
        acc = acc ^ (yy * xbits[..., i:i + 1])
        yy = halve_be(yy)
    return acc


# Host (numpy) matrix helpers: the per-key matrices are tiny, so they are
# built on the host and moved to the device once per key.

def _bits_np(blocks):
    b = (np.asarray(blocks, np.uint8)[..., :, None] >> np.arange(7, -1, -1)) & 1
    return b.reshape(np.asarray(blocks).shape[:-1] + (128,))


def _halve_be_np(x):
    y = (x >> 1).astype(np.uint8)
    y[..., 1:] |= (x[..., :-1] & 1) << 7
    y[..., 0] ^= (x[..., 15] & 1) * 0xE1
    return y


def _halve_le_np(x):
    """The POLYVAL twin of _halve_be_np: LE shift right by one bit; if the
    dropped bit (bit 0 of byte 0) was set, the last byte takes ^= 0xE1."""
    y = (x >> 1).astype(np.uint8)
    y[..., :-1] |= (x[..., 1:] & 1) << 7
    y[..., 15] ^= (x[..., 0] & 1) * 0xE1
    return y


def _unit_blocks() -> np.ndarray:
    """The 128 unit bit-vectors as blocks uint8[128, 16]."""
    eye = np.eye(128, dtype=np.uint8)
    return np.packbits(eye.reshape(128, 16, 8), axis=-1, bitorder="big").reshape(128, 16)


def ghash_matrix(h_block) -> np.ndarray:
    """M (numpy uint8[128,128]) with bits(mulGF128(H, y)) = M @ bits(y)."""
    hbits = _bits_np(np.asarray(h_block, np.uint8))
    y = _unit_blocks()
    acc = np.zeros((128, 16), np.uint8)
    for i in range(128):
        if hbits[i]:
            acc ^= y
        y = _halve_be_np(y)
    return _bits_np(acc).T.astype(np.uint8)


def polyval_matrix(h_block) -> np.ndarray:
    """M (numpy uint8[128,128]) with bits(dotGF128(H, y)) = M @ bits(y):
    POLYVAL's product by H, whose bits of H run from byte 15 down and
    whose halving is little-endian."""
    hb = _bits_np(np.asarray(h_block, np.uint8)).reshape(16, 8)[::-1].reshape(128)
    y = _unit_blocks()
    acc = np.zeros((128, 16), np.uint8)
    for i in range(128):
        y = _halve_le_np(y)
        if hb[i]:
            acc ^= y
    return _bits_np(acc).T.astype(np.uint8)


def mat_power_gf2_np(m, k: int) -> np.ndarray:
    """M^k over GF(2) in numpy (square-and-multiply)."""
    result = np.eye(128, dtype=np.int64)
    base = np.asarray(m, np.uint8).astype(np.int64)
    while k:
        if k & 1:
            result = (result @ base) % 2
        k >>= 1
        if k:
            base = (base @ base) % 2
    return result.astype(np.uint8)


def gf2_matinv_np(m) -> np.ndarray:
    """Inverse of a GF(2) matrix (numpy Gaussian elimination, any size)."""
    m = np.asarray(m, dtype=np.uint8)
    n = m.shape[0]
    a = np.concatenate([m.copy(), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r, col])
        a[[col, piv]] = a[[piv, col]]
        for r in range(n):
            if r != col and a[r, col]:
                a[r] ^= a[col]
    return a[:, n:]
