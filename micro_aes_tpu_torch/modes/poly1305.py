"""Poly1305-AES MAC (Bernstein 2005), parity with micro_aes.c:1901-1996.

The reference does schoolbook 17-byte-limb arithmetic; chunks are processed
back-to-front with rising powers of r (c:1976-1986), i.e.

    poly = sum_j chunk_j * r^(q+1-j)  mod 2^130-5,
    tag  = poly + AES_k(nonce)  mod 2^128.

Below `_BULK_THRESHOLD` bytes the sum runs on the host as a Horner loop of
Python ints (exact); at or above it the whole chunks fold on the request's
device as float64 products over powers of r (ops/poly_bulk), and only the
ragged tail chunk and the final reduction run on the host.  AES_k(nonce)
runs on the request's device either way.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.poly_bulk import limbs_to_int, poly_fold, poly_power_tables
from ..utils.bytesio import BLOCK, to_u8
from .common import enc_block

P1305 = (1 << 130) - 5

# poly1305_aes routes messages at or above this size through the device
# fold (poly1305_aes_bulk); below it the Horner host loop wins (no device
# work beyond one block, no power-table build).
_BULK_THRESHOLD = 1 << 16


def _clamp_r(r: bytes) -> int:
    """r-clamping (micro_aes.c:1969-1974)."""
    b = bytearray(r[:16])
    for i in (3, 7, 11, 15):
        b[i] &= 0x0F
    for i in (4, 8, 12):
        b[i] &= 0xFC
    return int.from_bytes(bytes(b), "little")


def _split(keys, nonce, data, device):
    """(clamped r, s = AES_k(nonce) as an int, data bytes)."""
    keys = bytes(keys)
    klen = len(keys) - 16
    s = enc_block(keys[:klen], to_u8(nonce)[:BLOCK], device).cpu().numpy()
    return _clamp_r(keys[klen:]), int.from_bytes(s.tobytes(), "little"), bytes(to_u8(data))


def poly1305_aes(keys, nonce, data, *, device="cuda") -> bytes:
    """AES_Poly1305 (micro_aes.c:1956-1996).  keys = AES key (16/24/32 B)
    || r (16 B); nonce is one block."""
    if len(to_u8(data)) >= _BULK_THRESHOLD:
        return poly1305_aes_bulk(keys, nonce, data, device=device)
    r, s, data = _split(keys, nonce, data, device)
    # Horner form of sum_j chunk_j * r^(q+1-j): poly = (poly + c_j) * r
    poly = 0
    for j in range(0, len(data), BLOCK):
        c = int.from_bytes(data[j: j + BLOCK] + b"\x01", "little")
        poly = ((poly + c) * r) % P1305
    return int.to_bytes((poly + s) % (1 << 128), 16, "little")


def poly1305_aes_bulk(keys, nonce, data, *, device="cuda") -> bytes:
    """Poly1305-AES with the whole chunks folded on `device` as float64
    products over powers of r (ops/poly_bulk); the ragged tail chunk and the
    final reduction run on the host.  Bit-exact against poly1305_aes."""
    dev = torch.device(device)
    r, s, data = _split(keys, nonce, data, dev)
    nf, tail_len = divmod(len(data), BLOCK)
    poly = 0
    if nf:
        n = nf + ((-nf) % 32)
        buf = np.zeros(n * BLOCK, np.uint8)  # front-padded with zero chunks
        buf[(n - nf) * BLOCK:] = np.frombuffer(data, np.uint8, nf * BLOCK)
        words = torch.from_numpy(buf).to(dev).view(torch.int32).reshape(n, 4).T
        # front-padded zero chunks get no pad bit
        pad_mask = torch.arange(n, device=dev) >= n - nf
        poly = limbs_to_int(poly_fold(poly_power_tables(r, n, dev), words, pad_mask))
    if tail_len:
        c_tail = int.from_bytes(data[nf * BLOCK:] + b"\x01", "little")
        poly = ((poly + c_tail) * r) % P1305
    return int.to_bytes((poly + s) % (1 << 128), 16, "little")
