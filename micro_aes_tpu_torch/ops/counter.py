"""GCM/CTR counter blocks generated directly in bitsliced plane form.

The counter stream is computed from the block index alone, so the whole
keystream is embarrassingly parallel.  incBlock's big-endian contract
(micro_aes.c:421-428) is reproduced exactly: counting runs over bytes 15
down to 9, a 56-bit window split as lo32 (bytes 12..15) and a 24-bit
extension hi24 (bytes 9..11) that takes lo's carry.  GCM-SIV counts the
other way (incBlock with index 0): little-endian over bytes 0..3, mod 2^32
(`counter_blocks(..., endian="le32")`; its bulk kernels build these
counters themselves, ops/siv_kernels).

With a 32-aligned generation start, bits 0..4 of the counter are fixed
lane patterns and every other bit is a per-word broadcast, so a word of
32 counter blocks is described by J0's bits (`j0_planes`) and two words
per 32 blocks (`lohi_words`); those are the operands of the fused kernels
(ops/seal_kernels), and `counter_planes` expands them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.bytesio import i32_from_u32, u32_tensor

# Lane patterns of bit k (k < 5) of 32 consecutive aligned integers.
_LOW_BIT_PATTERNS = np.array(
    [0xAAAAAAAA, 0xCCCCCCCC, 0xF0F0F0F0, 0xFF00FF00, 0xFFFF0000],
    dtype=np.uint32,
)
_M32 = 0xFFFFFFFF

# Source of each counter-plane row q = b*16 + pos (static): sel 0 = J0
# broadcast bit (pos <= 8), 1 = fixed lane pattern (counter bit k < 5),
# 2 = bit k of lo, 3 = bit k of hi
_CTR_SEL = np.zeros(128, np.int64)
_CTR_SHIFT = np.zeros(128, np.int32)
_CTR_PATTERN = np.zeros(128, np.uint32)
for _q in range(128):
    _b, _pos = _q // 16, _q % 16
    if _pos >= 12:
        _k = 8 * (15 - _pos) + _b
        if _k < 5:
            _CTR_SEL[_q] = 1
            _CTR_PATTERN[_q] = _LOW_BIT_PATTERNS[_k]
        else:
            _CTR_SEL[_q] = 2
            _CTR_SHIFT[_q] = _k
    elif _pos >= 9:
        _CTR_SEL[_q] = 3
        _CTR_SHIFT[_q] = 8 * (11 - _pos) + _b
del _q, _b, _pos, _k


def counter_lohi(j0: torch.Tensor, nwords: int, start: int):
    """Per-word counter values of the 56-bit window: (lo, hi) int64[W] with
    lo = low 32 bits of ctr56(j0) + start + 32w (mod 2^32) and hi = the
    24-bit byte-9..11 extension, carries included.  `start` is a signed
    32-bit offset, sign-extended into the window."""
    b = j0.to(torch.int64)
    lo0 = (b[12] << 24) | (b[13] << 16) | (b[14] << 8) | b[15]
    hi0 = (b[9] << 16) | (b[10] << 8) | b[11]
    sext = _M32 if start < 0 else 0
    base_lo = (lo0 + (start & _M32)) & _M32
    carry0 = (base_lo < lo0).to(torch.int64)
    widx = torch.arange(nwords, dtype=torch.int64, device=j0.device) * 32
    lo = (base_lo + widx) & _M32
    carry = carry0 + (lo < base_lo).to(torch.int64)
    hi = (hi0 + sext + carry) & 0xFFFFFF
    return lo, hi


def lohi_words(j0: torch.Tensor, nwords: int, start: int) -> torch.Tensor:
    """Kernel operand lohi: int32[2, W], the per-word counter values (lo)
    and their 24-bit extensions (hi) of a stream starting at J0 + start."""
    return i32_from_u32(torch.stack(counter_lohi(j0, nwords, start)))


def j0_planes(j0: torch.Tensor) -> torch.Tensor:
    """Kernel operand j0c: uint8[16] -> int32[128, 1], bit b of byte p as
    0/-1 at row b*16+p."""
    shifts = torch.arange(8, dtype=torch.uint8, device=j0.device)
    bits = (j0[:, None] >> shifts) & 1  # [16, 8]
    return -(bits.T.reshape(128, 1).to(torch.int32))


def counter_planes(j0c: torch.Tensor, lohi: torch.Tensor) -> torch.Tensor:
    """Expand the kernel operands into GCM counter planes int32[128, W]
    (row q = b*16 + pos); requires a 32-aligned generation start."""
    dev = lohi.device
    lo, hi = lohi[0:1, :], lohi[1:2, :]
    sel = torch.as_tensor(_CTR_SEL, device=dev)[:, None]
    shift = torch.as_tensor(_CTR_SHIFT, device=dev)[:, None]
    from_lo = -((lo >> shift) & 1)
    from_hi = -((hi >> shift) & 1)
    pattern = u32_tensor(_CTR_PATTERN, dev)[:, None].expand_as(from_lo)
    return torch.where(sel == 0, j0c.expand_as(from_lo),
                       torch.where(sel == 1, pattern,
                                   torch.where(sel == 2, from_lo, from_hi)))


def ctr56_add(base: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """uint8[..., 16] counter blocks + int64 delta (broadcast against the
    leading axes) on the 56-bit big-endian window over bytes 9..15, the
    carry stopping at byte 9 (incBlock, micro_aes.c:421-428)."""
    b = base.to(torch.int64)
    v = torch.zeros_like(b[..., 0])
    for p in range(9, 16):
        v = (v << 8) | b[..., p]
    v = (v + delta) & ((1 << 56) - 1)
    shifts = torch.arange(48, -8, -8, dtype=torch.int64, device=base.device)
    tail = ((v[..., None] >> shifts) & 0xFF).to(torch.uint8)
    return torch.cat([base[..., :9].expand(tail.shape[:-1] + (9,)), tail], dim=-1)


def counter_blocks(base: torch.Tensor, n: int, offset: int = 0,
                   endian: str = "be") -> torch.Tensor:
    """uint8[16] base -> uint8[n, 16] counter blocks base+offset ..
    base+offset+n-1: "be" counts on the 56-bit big-endian window of
    ctr56_add, "le32" (GCM-SIV) on the little-endian word in bytes 0..3,
    mod 2^32 with no carry into byte 4."""
    i = torch.arange(n, dtype=torch.int64, device=base.device) + offset
    if endian == "be":
        return ctr56_add(base, i)
    if endian != "le32":
        raise ValueError(f"unknown endian {endian!r}")
    b = base.to(torch.int64)
    v = ((b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)) + i) & _M32
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=base.device)
    head = ((v[:, None] >> shifts) & 0xFF).to(torch.uint8)
    return torch.cat([head, base[4:].expand(n, 12)], dim=1)


def counter_planes_be(j0: torch.Tensor, nwords: int, start: int) -> torch.Tensor:
    """BE-counter blocks in bitsliced plane form: int32[8, 16, W] where word
    w covers counter values ctr56(j0) + start + 32w + j for lane j.
    Requires (ctr56(j0) + start) % 32 == 0.  j0 is a uint8[16] tensor on
    the target device."""
    planes = counter_planes(j0_planes(j0), lohi_words(j0, nwords, start))
    return planes.reshape(8, 16, nwords)
