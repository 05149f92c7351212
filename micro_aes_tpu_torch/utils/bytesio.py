"""Byte and word helpers shared across the port: the block size, the
constant-time tag comparison, bytes to zero-padded block arrays, the
forgiving hex decoder, the block-count buckets of the batch engines and the
uint32 -> int32 tensor boundary."""
from __future__ import annotations

import hmac

import numpy as np
import torch

BLOCK = 16


def u32_tensor(arr, device) -> torch.Tensor:
    """uint32 numpy data -> int32 tensor holding the same bits.

    torch's uint32 lacks shifts, adds and compares (only ^ and & work), so
    the port holds every 32-bit word as int32 and masks after a right
    shift, which is arithmetic on int32."""
    a = np.ascontiguousarray(np.asarray(arr).astype(np.uint32, copy=False))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def i32_from_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of uint32 values -> int32 tensor of the same bits."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _host_bytes(x) -> bytes:
    """bytes / bytearray / ndarray / CPU-or-CUDA tensor -> host bytes."""
    if isinstance(x, (bytes, bytearray)):
        return bytes(x)
    if hasattr(x, "detach"):  # torch.Tensor: reduce to host memory first
        x = x.detach().cpu().numpy()
    return bytes(np.asarray(x, dtype=np.uint8).reshape(-1))


def verify_tag(expect, got) -> bool:
    """Constant-time tag comparison (reference: the memcmp_s helper under
    INCREASE_SECURITY, micro_aes.c:369-384).

    Both sides are reduced to host bytes first (device work is over by
    then), and the comparison is `hmac.compare_digest`, whose time does not
    depend on where the first mismatch lies.  A length mismatch returns
    False."""
    eb, gb = _host_bytes(expect), _host_bytes(got)
    if len(eb) != len(gb):
        return False
    return hmac.compare_digest(eb, gb)


def to_u8(data) -> np.ndarray:
    """bytes / bytearray / ndarray / None -> flat uint8 ndarray (no copy
    where possible)."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    if data is None:
        return np.zeros(0, dtype=np.uint8)
    return np.frombuffer(bytes(data), dtype=np.uint8)


def to_blocks(data) -> np.ndarray:
    """Flat bytes -> zero-padded uint8[N, 16] block array."""
    flat = to_u8(data)
    n = len(flat)
    out = np.zeros(-(-n // BLOCK) * BLOCK, dtype=np.uint8)
    out[:n] = flat
    return out.reshape(-1, BLOCK)


def hex2bytes(s: str) -> bytes:
    """Forgiving hex decoder (ignores whitespace), like main.c:97-106."""
    return bytes.fromhex("".join(s.split()))


def block_bucket(nblocks: int) -> int:
    """A block count rounded up to a power of two (at least 1): the batch
    engines group messages by it, so a group pads each message to at most
    twice its length."""
    b = 1
    while b < nblocks:
        b *= 2
    return b
