"""Bulk GHASH (and POLYVAL, from its own M_H): the serial Horner fold
reformulated as GF(2) matrix products.

GHASH over n blocks is G = sum_i M_H^(n-i+1) c_i (M_H = the per-key GF(2)
bit-matrix, ops/gf128.ghash_matrix).  Decomposition:

  level 1:  chunks of C=32 blocks (one bitslice word) -> [T, 4096] @
            [4096, 128] (inside the fused kernels on the card)
  level 2:  groups of C2 chunks -> the same with powers of M^32
  combine:  32-way span folds, then a log-depth pairwise ladder

Leading zero blocks contribute nothing (exponents count from the end), so
fronts pad freely to tile boundaries.

The products outside the kernel run as float64 matrix products of 0/1
operands, on both devices: every sum is at most 4096, far below 2^53, so
the product is exact, and `& 1` takes the parity.  float64 has no TF32 or
reduced-precision mode, so the result does not depend on the process's
matmul settings.  (CUDA has no general int8 product, and on the CPU int8 @
int8 returns int8 and wraps mod 256.)
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.bytesio import i32_from_u32
from .gf128 import bits_to_blocks, blocks_to_bits

CHUNK = 32     # blocks per level-1 chunk == bits per bitslice word
CHUNK2 = 32    # chunks per level-2 group

# rows of W1 arrive as (j, b, p): lane j, bit b, byte p; the standard
# GHASH bit order within a block is q = 8p + (7-b) (MSB-first per byte).
_PLANE_PERM = np.concatenate([
    j * 128 + np.array([8 * p + (7 - b) for b in range(8) for p in range(16)])
    for j in range(CHUNK)
])

SPAN_LEVELS = 2     # extra 32-way combine levels
SPAN_FAN = 32       # rows folded per extra level


def pack_level1(w1):
    """W1 [4096, 128] (plane order, row j*128 + q: lane j, plane q) -> the
    seal kernel's level-1 operand W1p int32[128, 128], packed by lane:
    bit j of W1p[o, q] = W1[j*128 + q, o].  64 KiB instead of the 512 KiB
    of int8 W1^T, so it fits in a block's shared memory.  A tensor gives a
    tensor on its device, a numpy array a numpy array."""
    if isinstance(w1, np.ndarray):
        return pack_level1(torch.from_numpy(np.array(w1))).numpy()
    bits = w1.reshape(CHUNK, 128, 128).to(torch.int64) & 1
    lanes = torch.arange(CHUNK, dtype=torch.int64, device=w1.device)[:, None, None]
    return i32_from_u32((bits << lanes).sum(dim=0).T).contiguous()


def unpack_level1(w1p: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_level1, transposed: W1p -> W1^T int8[128, 4096]
    (column j*128 + q) on w1p's device."""
    lanes = torch.arange(CHUNK, dtype=torch.int32, device=w1p.device)
    bits = (w1p.view(torch.int32)[:, None, :] >> lanes[None, :, None]) & 1
    return bits.reshape(128, CHUNK * 128).to(torch.int8)


def _powers(m: torch.Tensor, k: int) -> torch.Tensor:
    """[I, M, M^2, ..., M^k] over GF(2) as float64 [k+1, 128, 128]: each
    batched product doubles the stack, so k = 32 takes five."""
    p = torch.stack([torch.eye(128, dtype=m.dtype, device=m.device), m])
    while p.shape[0] <= k:
        p = torch.cat([p, torch.remainder(p[1:] @ p[-1], 2)])
    return p[: k + 1]


def _stacked_t(p: torch.Tensor) -> torch.Tensor:
    """[P_0, ..., P_{n-1}] -> rows P_{n-1}^T, ..., P_0^T as [n*128, 128]."""
    return p.flip(0).transpose(1, 2).reshape(-1, 128)


def ghash_power_tables(m_h, *, device):
    """Per-key precompute: (W1 [C*128,128], W2 [C2*128,128], M_outer, M_H,
    spans, W1p) on `device`: int8, except M_H uint8 and W1p int32.  W1
    row-block j holds (M^(C-j))^T in plane order (rows (j, b, p)), so
    S = c_flat @ W1 for plane-order bit rows; `spans` holds SPAN_LEVELS
    further (W, M_next) pairs that fold 32 rows per product; W1p is W1
    packed for the seal kernel (pack_level1).  The first five match the
    JAX package's plane-order tables.  The powers are float64 products
    mod 2 on `device` (exact, see the module note): twenty batched
    products, where host numpy took about half a second per key."""
    i8 = torch.int8
    m = torch.from_numpy(np.asarray(m_h, np.uint8)).to(device)
    p1 = _powers(m.to(torch.float64), CHUNK)
    w1 = _stacked_t(p1[1:])[torch.as_tensor(_PLANE_PERM, device=m.device)]
    p2 = _powers(p1[CHUNK], CHUNK2)  # powers of M^C
    spans, m_cur = [], p2[CHUNK2]     # M^(C*C2)
    for _ in range(SPAN_LEVELS):
        pws = _powers(m_cur, SPAN_FAN)
        spans.append((_stacked_t(pws[:SPAN_FAN]).to(i8), pws[SPAN_FAN].to(i8)))
        m_cur = pws[SPAN_FAN]
    return (w1.to(i8), _stacked_t(p2[:CHUNK2]).to(i8), p2[CHUNK2].to(i8), m,
            tuple(spans), pack_level1(w1))


def _gf2_matmul_i8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(x @ w) mod 2 for 0/1 operands -> int32 0/1 (exact float64 product,
    see the module note)."""
    acc = x.to(torch.float64) @ w.to(torch.float64)
    return acc.to(torch.int32) & 1


def _combine_logdepth(u: torch.Tensor, m_outer: torch.Tensor) -> torch.Tensor:
    """G = sum_g M^(S*(T2-1-g)) U_g via pairwise folds; log2(T2) products.
    u int8 [..., T2, 128] and m_outer [..., 128, 128] (leading axes: one
    fold per message) -> uint8 [..., 128]."""
    pow2 = 1
    while pow2 < u.shape[-2]:
        pow2 *= 2
    # front-pad: exponents count from the end
    u = torch.nn.functional.pad(u, (0, 0, pow2 - u.shape[-2], 0))
    m_span_t = m_outer.transpose(-1, -2)
    while u.shape[-2] > 1:
        left, right = u[..., 0::2, :], u[..., 1::2, :]
        u = (_gf2_matmul_i8(left, m_span_t) ^ right).to(torch.int8)
        if u.shape[-2] > 1:
            m_span_t = _gf2_matmul_i8(m_span_t, m_span_t).to(torch.int8)
    return u[..., 0, :].to(torch.uint8)


def combine_levels(u: torch.Tensor, tables) -> torch.Tensor:
    """Fold row partials u int8 [T, 128] (exponents count from the row
    stream's end; front-pad freely) into one accumulator uint8[128]: one
    32-way product per span level, then a log-depth ladder for whatever
    remains (nothing, for messages up to C*C2*32^2 blocks)."""
    m_cur = tables[2]
    for wsp, m_next in tables[4]:
        if u.shape[0] == 1:
            break
        pad = (-u.shape[0]) % SPAN_FAN
        if pad:
            u = torch.cat([u.new_zeros((pad, 128)), u], dim=0)
        u = _gf2_matmul_i8(u.reshape(u.shape[0] // SPAN_FAN, SPAN_FAN * 128),
                           wsp).to(torch.int8)
        m_cur = m_next
    return _combine_logdepth(u.to(torch.int8), m_cur)


def fold_level1(s1t: torch.Tensor, tables) -> torch.Tensor:
    """The fused kernels' level-1 partials s1 int8[128, W] (column w = the
    32-block row w; W a multiple of C2) -> accumulator uint8[128]: level
    2, then combine_levels."""
    w = s1t.shape[1]
    s2 = _gf2_matmul_i8(s1t.T.reshape(w // CHUNK2, CHUNK2 * 128), tables[1])
    return combine_levels(s2.to(torch.int8), tables)


def _levels(bits_flat: torch.Tensor, tables) -> torch.Tensor:
    """bits_flat [T, C*128] int8 -> folded accumulator uint8[128]."""
    t = bits_flat.shape[0]
    s1 = _gf2_matmul_i8(bits_flat, tables[0])
    s2 = _gf2_matmul_i8(s1.to(torch.int8).reshape(t // CHUNK2, CHUNK2 * 128),
                        tables[1])
    return combine_levels(s2.to(torch.int8), tables)


def planes_to_bits_i8(planes: torch.Tensor) -> torch.Tensor:
    """int32[8,16,W] -> int8[32*W, 128] per-block bit rows in *plane order*
    (b, p); slice or pad the block axis freely, then feed
    ghash_from_bits."""
    w = planes.shape[-1]
    lanes = torch.arange(32, dtype=torch.int32, device=planes.device)
    bits = ((planes[:, :, :, None] >> lanes) & 1).to(torch.int8)  # [8,16,W,32]
    return bits.permute(2, 3, 0, 1).reshape(32 * w, 128)


def ghash_from_bits(tables, bits: torch.Tensor) -> torch.Tensor:
    """Fold per-block bit rows [N, 128] in plane order (N a multiple of
    C*C2)."""
    n = bits.shape[0]
    return _levels(bits.reshape(n // CHUNK, CHUNK * 128), tables)


def ghash_finalize(tables, acc_bits: torch.Tensor,
                   len_block: torch.Tensor) -> torch.Tensor:
    """One more fold with the length block: G = M(acc ^ bits(len)) ->
    uint8[16]."""
    m_h = tables[3]
    x = (acc_bits ^ blocks_to_bits(len_block)).to(torch.int8)
    g = _gf2_matmul_i8(x, m_h.T.to(torch.int8)).to(torch.uint8)
    return bits_to_blocks(g)
