"""Bulk Poly1305: the serial Horner fold reformulated as matrix products.

Same shape as ops/ghash_bulk, but over the integers mod p = 2^130-5
instead of GF(2^128) (the reference's 17-byte-limb schoolbook arithmetic,
micro_aes.c:1901-1997):

  * field elements live in FIFTEEN 9-BIT LIMBS (values < 2^135 in
    redundant form).  Multiplication by a FIXED power of r is linear over
    Z, so chunk_i * r^k is a matrix-vector product whose matrix columns are
    limbs(2^(9*li) * r^k mod p), all entries < 2^9;
  * the layout is limb-major: the chunk axis is the last axis everywhere
    (limbs [15, N], fold operands [480, T], fold outputs [15, T]);
  * each level folds the array STRIDED: an array a[0..M) with invariant
    F = sum_t a[t] r^(M-t) splits as t = j*(M/32) + t', so column t' folds
    {a[t'], a[M/32+t'], ...}, 32 strided elements.  The [480, T] operand
    with row li*32+j = limb li of element j*T+t' is then a pure reshape of
    the [15, M] limb array.  The residual invariant keeps the same form
    with M -> M/32, so levels stack until M = 1; the last level bakes in
    the trailing r (exponents 32-j).  The tables depend on the level
    sizes, so they are per (r, padded length), cached;
  * each level is one float64 product Wt [15, 480] @ X [480, T] on whole
    limbs: every sum is below 480 * 511 * 511 < 2^27, far below 2^53, so
    the product is exact, and float64 has no TF32 or reduced-precision
    mode (the JAX package splits each limb into two int8 digits for four
    int8 MXU products instead; CUDA has no general integer product);
  * between levels the redundant limbs renormalize to 9 bits with the
    2^135 = 160 (mod p) wraparound, a 15-step carry chain over [T] rows
    in int32; the final canonical reduction runs on the host on 15 small
    ints.

The fold convention matches modes/poly1305 (micro_aes.c:1976-1986):
F = sum_i c_i * r^(N-i) over chunks c_0..c_{N-1}, each c = chunk||0x01
little-endian.  Zero chunks contribute nothing and front-padding an array
only shifts M together with t, so fronts pad freely to 32-boundaries.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.keycache import key_cache

P1305 = (1 << 130) - 5
LIMBS = 15          # 9-bit limbs: 135 bits of redundant headroom
LIMB_BITS = 9
LIMB_MASK = (1 << LIMB_BITS) - 1
FAN = 32            # strided groups folded per level
WRAP135 = 160       # 2^135 mod p  (2^130 = 5 -> 2^135 = 32*5)


def _to_limbs(x: int) -> list[int]:
    return [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(LIMBS)]


def _level_sizes(n: int) -> list[tuple[int, int]]:
    """[(padded M, M/32)] per level for a fold starting at n elements."""
    sizes = []
    m = max(n, 1)
    while m > 1:
        m += (-m) % FAN
        sizes.append((m, m // FAN))
        m //= FAN
    return sizes or [(FAN, 1)]


@key_cache(maxsize=256)
def poly_power_tables(r: int, n: int, device) -> tuple[torch.Tensor, ...]:
    """Per-(r, chunk-count) precompute: one float64 matrix Wt
    [LIMBS, FAN*LIMBS] of whole 9-bit limbs per fold level, on `device`.
    The level with input size M (padded) and stride T = M/32 folds element
    j*T+t with coefficient r^(T*(31-j)) (plus the trailing r on the last
    level: exponents 32-j), preserving the invariant F = sum_t out[t]
    r^(T-t).  Column c = li*FAN + j matches the reshape-only operand."""
    tables = []
    base = r % P1305
    sizes = _level_sizes(n)
    for lvl, (_, t) in enumerate(sizes):
        last = lvl == len(sizes) - 1
        w = np.zeros((FAN * LIMBS, LIMBS), np.float64)
        for j in range(FAN):
            e = t * (FAN - 1 - j) + (1 if last else 0)
            g = pow(base, e, P1305)
            for li in range(LIMBS):
                w[li * FAN + j] = _to_limbs(((1 << (LIMB_BITS * li)) * g) % P1305)
        tables.append(torch.from_numpy(np.ascontiguousarray(w.T)).to(device))
    return tuple(tables)


def _normalize(y: torch.Tensor) -> torch.Tensor:
    """Redundant [LIMBS, T] int32 -> 9-bit limbs, same value mod p.  Two
    full carry chains with the 2^135 wraparound, then a final short wrap
    (bounds: level outputs < 2^27 per limb; after pass 1 the overflow carry
    is < 2^18, after pass 2 it is 0 or 1).  The values are non-negative, so
    the arithmetic shift of int32 is the logical one."""
    for _ in range(2):
        c = torch.zeros_like(y[0])
        rows = []
        for k in range(LIMBS):
            t = y[k] + c
            rows.append(t & LIMB_MASK)
            c = t >> LIMB_BITS
        rows[0] = rows[0] + c * WRAP135
        y = torch.stack(rows)
    # after two passes only limb 0 can exceed 9 bits, by < 2^14: one short
    # ripple is enough (it cannot overflow limb 1's headroom)
    y = y.clone()
    c = y[0] >> LIMB_BITS
    y[0] &= LIMB_MASK
    y[1] += c
    return y


def chunk_limbs_from_words(words: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
    """Little-endian words int32[4, N] (word k of chunk n at [k, n], the
    bits of uint32) -> normalized limb rows int32[LIMBS, N] of c_n = chunk
    || pad, where pad_mask[n] (0/1) adds the 2^128 pad bit (bit 2 of limb
    14) for the chunks it marks.  The words widen to int64 first, so every
    shift is logical (torch's uint32 has no shifts)."""
    w = [words[k].to(torch.int64) & 0xFFFFFFFF for k in range(4)]
    rows = []
    for li in range(LIMBS):
        bit0 = LIMB_BITS * li
        k0, s = bit0 // 32, bit0 % 32
        if k0 >= 4:
            v = torch.zeros_like(w[0])
        else:
            v = w[k0] >> s
            if s > 32 - LIMB_BITS and k0 + 1 < 4:
                v = v | (w[k0 + 1] << (32 - s))
        rows.append((v & LIMB_MASK).to(torch.int32))
    limbs = torch.stack(rows)  # [15, N]
    limbs[14] += pad_mask.to(torch.int32) << 2
    return limbs


def poly_fold(tables, words: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
    """F = sum_i c_i r^(N-i) over N chunks given as little-endian words
    int32[4, N] (N a multiple of 32; front-pad with zero words and pad_mask
    zeros; tables = poly_power_tables(r, N, device)), on the words' device
    -> the normalized limb row int32[LIMBS]."""
    rows = chunk_limbs_from_words(words, pad_mask)  # [15, N]
    for wt in tables:
        pad = (-rows.shape[1]) % FAN
        if pad:
            rows = torch.nn.functional.pad(rows, (pad, 0))
        t = rows.shape[1] // FAN
        # strided operand: row li*32+j of column t' = limbs[li, j*t+t'],
        # a pure reshape of the [15, M] limb array (see module doc)
        x = rows.reshape(FAN * LIMBS, t).to(torch.float64)
        rows = _normalize((wt @ x).to(torch.int32))
    return rows[:, 0]


def limbs_to_int(limbs) -> int:
    """Host: normalized limb row (tensor or array) -> canonical integer
    mod p."""
    if torch.is_tensor(limbs):
        limbs = limbs.cpu().numpy()
    v = 0
    for i, x in enumerate(np.asarray(limbs).tolist()):
        v += int(x) << (LIMB_BITS * i)
    return v % P1305
