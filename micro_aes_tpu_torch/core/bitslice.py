"""Bitsliced AES on int32 planes: the S-box as a boolean circuit.

Each of the 128 state bits becomes a *plane* — a 32-bit word holding that
bit for 32 blocks — and every AES round is XOR/AND plane algebra:

  * SubBytes  -> the Boyar–Peralta logic-minimized circuit (forward: 115
                 netlist gates); the inverse is DERIVED at import from the
                 forward circuit's shared nonlinear middle by composing its
                 probed linear layers with the inverse affine map (see the
                 S-box section below); both directions are checked against
                 all 256 entries of the algebraically derived tables at
                 import (`_selfcheck`);
  * ShiftRows -> a static permutation of the 16 byte-position rows;
  * MixColumns-> xtime is a plane-index shuffle + conditional XOR;
  * AddRoundKey-> XOR with broadcast key planes.

State layout: planes[8, 16, W] — bit index, byte position, packed batch
(W = N/32 blocks), held as int32 (torch's uint32 has no shifts; see
utils/bytesio.u32_tensor).  The circuit functions work on any array type
with ^, & and ~ (torch tensors here, numpy in the self-check); the CUDA
kernels in csrc/ run the same netlists (csrc/aes_bitslice.cuh, and the
generated csrc/sbox_inv.cuh for the derived inverse).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.gf128 import gf2_matinv_np
from .cipher import INV_SHIFT_PERM, SHIFT_PERM
from .sbox import INV_SBOX, SBOX


def _affine_matrix():
    """L of the AES affine transform y = L x ^ 0x63."""
    L = np.zeros((8, 8), dtype=np.uint8)
    for k in range(8):
        for j in range(5):  # x, rotl1..rotl4
            L[k, (k - j) % 8] ^= 1
    return L


_L = _affine_matrix()
_LI = gf2_matinv_np(_L)
_C_BITS = np.array([(0x63 >> k) & 1 for k in range(8)], np.uint8)


# ---------------------------------------------------------------------------
# S-box circuit
# ---------------------------------------------------------------------------
# Forward: the logic-minimized circuit of Boyar & Peralta ("A new
# combinational logic minimization technique with applications to
# cryptology", SEA 2010): 115 netlist gates.
#
# Inverse: derived, not transcribed.  The netlist factors as
# S(x) = bottom(middle(top(x))) with top/bottom linear over GF(2) and a
# shared nonlinear middle computing the field inversion, so with
# S(x) = L·inv(x) ^ 0x63 the inverse S⁻¹(x) = inv(L⁻¹(x ^ 0x63)) needs only
# new linear layers: probe the forward top matrix R (y = R·x) and bottom
# affine map (s = M·z ^ k) with unit vectors, compose both with L⁻¹, and
# re-factor the composed matrices into straight-line XOR programs
# (randomized-restart Paar CSE, fixed seed 0, 200 restarts: the same seed
# gives the same netlist as the JAX package's).  The 0x63 input constant
# becomes NOTs on the planes of its set bits.


def _bp_top(u):
    """Top linear layer: u = [U0..U7] MSB-first input bits -> the 22
    shared signals [y1..y21, U7] the nonlinear middle consumes."""
    u0, u1, u2, u3, u4, u5, u6, u7 = u
    y14 = u3 ^ u5
    y13 = u0 ^ u6
    y9 = u0 ^ u3
    y8 = u0 ^ u5
    t0 = u1 ^ u2
    y1 = t0 ^ u7
    y4 = y1 ^ u3
    y12 = y13 ^ y14
    y2 = y1 ^ u0
    y5 = y1 ^ u6
    y3 = y5 ^ y8
    t1 = u4 ^ y12
    y15 = t1 ^ u5
    y20 = t1 ^ u1
    y6 = y15 ^ u7
    y10 = y15 ^ t0
    y11 = y20 ^ y9
    y7 = u7 ^ y11
    y17 = y10 ^ y11
    y19 = y10 ^ y8
    y16 = t0 ^ y11
    y21 = y13 ^ y16
    y18 = u0 ^ y16
    return [y1, y2, y3, y4, y5, y6, y7, y8, y9, y10, y11, y12, y13, y14,
            y15, y16, y17, y18, y19, y20, y21, u7]


def _bp_middle(ys):
    """Shared nonlinear middle (32 AND + 30 XOR): GF(2^8) inversion in the
    circuit's internal basis; 22 signals in, 18 products out."""
    (y1, y2, y3, y4, y5, y6, y7, y8, y9, y10, y11, y12, y13, y14, y15,
     y16, y17, y18, y19, y20, y21, u7) = ys
    t2 = y12 & y15
    t3 = y3 & y6
    t4 = t3 ^ t2
    t5 = y4 & u7
    t6 = t5 ^ t2
    t7 = y13 & y16
    t8 = y5 & y1
    t9 = t8 ^ t7
    t10 = y2 & y7
    t11 = t10 ^ t7
    t12 = y9 & y11
    t13 = y14 & y17
    t14 = t13 ^ t12
    t15 = y8 & y10
    t16 = t15 ^ t12
    t17 = t4 ^ t14
    t18 = t6 ^ t16
    t19 = t9 ^ t14
    t20 = t11 ^ t16
    t21 = t17 ^ y20
    t22 = t18 ^ y19
    t23 = t19 ^ y21
    t24 = t20 ^ y18
    t25 = t21 ^ t22
    t26 = t21 & t23
    t27 = t24 ^ t26
    t28 = t25 & t27
    t29 = t28 ^ t22
    t30 = t23 ^ t24
    t31 = t22 ^ t26
    t32 = t31 & t30
    t33 = t32 ^ t24
    t34 = t23 ^ t33
    t35 = t27 ^ t33
    t36 = t24 & t35
    t37 = t36 ^ t34
    t38 = t27 ^ t36
    t39 = t29 & t38
    t40 = t25 ^ t39
    t41 = t40 ^ t37
    t42 = t29 ^ t33
    t43 = t29 ^ t40
    t44 = t33 ^ t37
    t45 = t42 ^ t41
    return [t44 & y15, t37 & y6, t33 & u7, t43 & y16, t40 & y1,
            t29 & y7, t42 & y11, t45 & y17, t41 & y10, t44 & y12,
            t37 & y3, t33 & y4, t43 & y13, t40 & y5, t29 & y2,
            t42 & y9, t45 & y14, t41 & y8]


def _bp_bottom(z):
    """Bottom affine layer: 18 products -> [S0..S7] MSB-first output bits
    (the four XNORs realize the 0x63 affine constant)."""
    (z0, z1, z2, z3, z4, z5, z6, z7, z8, z9, z10, z11, z12, z13, z14,
     z15, z16, z17) = z
    t46 = z15 ^ z16
    t47 = z10 ^ z11
    t48 = z5 ^ z13
    t49 = z9 ^ z10
    t50 = z2 ^ z12
    t51 = z2 ^ z5
    t52 = z7 ^ z8
    t53 = z0 ^ z3
    t54 = z6 ^ z7
    t55 = z16 ^ z17
    t56 = z12 ^ t48
    t57 = t50 ^ t53
    t58 = z4 ^ t46
    t59 = z3 ^ t54
    t60 = t46 ^ t57
    t61 = z14 ^ t57
    t62 = t52 ^ t58
    t63 = t49 ^ t58
    t64 = z4 ^ t59
    t65 = t61 ^ t62
    t66 = z1 ^ t63
    s0 = t59 ^ t63
    s6 = ~(t56 ^ t62)
    s7 = ~(t48 ^ t60)
    t67 = t64 ^ t65
    s3 = t53 ^ t66
    s4 = t51 ^ t66
    s5 = t47 ^ t65
    s1 = ~(t64 ^ s3)
    s2 = ~(t55 ^ t67)
    return [s0, s1, s2, s3, s4, s5, s6, s7]


def _xor_program(mat, restarts: int = 200, seed: int = 0):
    """Factor a GF(2) matrix [m, n] into a straight-line XOR program over n
    inputs by randomized-restart Paar pair-factoring.  Returns
    (ops, outputs): ops are (a, b) signal-index pairs appended after the n
    inputs; outputs[k] is the signal index of row k (-1 = zero row)."""
    import random
    from collections import Counter

    m, n = mat.shape
    best = None
    rng = random.Random(seed)
    for _ in range(restarts):
        rows = [set(np.nonzero(mat[r])[0].tolist()) for r in range(m)]
        nsignals = n
        ops: list[tuple[int, int]] = []
        while True:
            pairs = Counter()
            for r in rows:
                rs = sorted(r)
                for x in range(len(rs)):
                    for y in range(x + 1, len(rs)):
                        pairs[(rs[x], rs[y])] += 1
            if not pairs:
                break
            mx = max(pairs.values())
            cand = sorted(p for p, c in pairs.items() if c == mx)
            a, b = cand[rng.randrange(len(cand))]
            ops.append((a, b))
            new = nsignals
            nsignals += 1
            for r in rows:
                if a in r and b in r:
                    r.discard(a)
                    r.discard(b)
                    r.add(new)
            if all(len(r) <= 1 for r in rows):
                break
        if best is None or len(ops) < len(best[0]):
            best = (ops, [next(iter(r)) if r else -1 for r in rows])
    return best


def _derive_inverse_programs():
    """Probe the forward netlist's linear layers and compose them with the
    inverse affine transform (see the section comment above)."""
    # top: R[i] = bits of middle-input signal i as a function of x (x
    # LSB-first; the netlist's U vector is MSB-first)
    r_mat = np.zeros((22, 8), np.uint8)
    for b in range(8):
        x = [0] * 8
        x[b] = 1
        r_mat[:, b] = np.array(_bp_top(x[::-1]), np.uint8) & 1
    # bottom: s = M.z ^ k (probed with ints; ~v flips bit 0 in two's
    # complement, so masking with 1 is exact)
    k_bits = np.array([_bp_bottom([0] * 18)[7 - b] & 1 for b in range(8)],
                      np.uint8)
    m_mat = np.zeros((8, 18), np.uint8)
    for j in range(18):
        z = [0] * 18
        z[j] = 1
        s = _bp_bottom(z)
        m_mat[:, j] = np.array([s[7 - b] & 1 for b in range(8)],
                               np.uint8) ^ k_bits
    # S⁻¹(x) = inv(w), w = L⁻¹(x ^ c):  y = (R L⁻¹)(x ^ c) feeds the
    # middle; inv(w) = (L⁻¹ M).z ^ L⁻¹(k ^ c)
    top = (r_mat @ _LI) % 2
    bot = (_LI @ m_mat) % 2
    bot_const = (_LI @ (k_bits ^ _C_BITS)) % 2
    return (_xor_program(top), _xor_program(bot),
            [int(v) for v in bot_const])


(_INV_TOP_OPS, _INV_TOP_OUT), (_INV_BOT_OPS, _INV_BOT_OUT), _INV_BOT_CONST = \
    _derive_inverse_programs()


def _run_program(inputs, ops, outs, consts=None):
    signals = list(inputs)
    for a, b in ops:
        signals.append(signals[a] ^ signals[b])
    out = []
    for k, idx in enumerate(outs):
        acc = signals[idx] if idx >= 0 else inputs[0] ^ inputs[0]
        if consts is not None and consts[k]:
            acc = ~acc
        out.append(acc)
    return out


def sbox_planes(planes, forward: bool = True):
    """Apply (inverse) SubBytes to a list of 8 bit-planes (LSB-first)."""
    if forward:
        return _bp_bottom(_bp_middle(_bp_top(planes[::-1])))[::-1]
    x = [~planes[b] if _C_BITS[b] else planes[b] for b in range(8)]
    ys = _run_program(x, _INV_TOP_OPS, _INV_TOP_OUT)
    z = _bp_middle(ys)
    return _run_program(z, _INV_BOT_OPS, _INV_BOT_OUT, _INV_BOT_CONST)


def _xtime_planes(p):
    """Bitsliced GF(2^8) doubling: y = x<<1 ^ 0x1b*(x>>7)."""
    return [p[7], p[0] ^ p[7], p[1], p[2] ^ p[7], p[3] ^ p[7],
            p[4], p[5], p[6]]


def _selfcheck():
    """Both circuit directions against all 256 entries of the derived
    tables (numpy int32 0/1 planes; ~ is masked off with & 1)."""
    x = np.arange(256, dtype=np.uint8)
    planes = [((x >> b) & 1).astype(np.int32) for b in range(8)]
    for forward, table in ((True, SBOX), (False, INV_SBOX)):
        out = sbox_planes(planes, forward)
        got = np.zeros(256, dtype=np.int32)
        for b in range(8):
            got |= (out[b] & 1) << b
        if not np.array_equal(got.astype(np.uint8), table):
            raise RuntimeError(
                f"bitsliced S-box circuit (forward={forward}) disagrees "
                "with the derived table")


_selfcheck()


# ---------------------------------------------------------------------------
# Word <-> plane butterflies and the full bitsliced cipher (torch, int32)
# ---------------------------------------------------------------------------


def _transpose32(rows: list) -> list:
    """32x32 bit-matrix transpose on 32 int32 vectors (Hacker's-Delight
    butterfly, 5 stages of masked swaps), vectorized over the trailing
    axis: out[i] bit j == in[j] bit i.  The right shift is arithmetic on
    int32, but every mask m has zeros in its top j bits, so the sign copies
    never survive the & m."""
    a = list(rows)
    j = 16
    m = 0x0000FFFF
    while j:
        k = 0
        while k < 32:
            # LSB-first variant: row k's HIGH bits pair with row k+j's LOW
            t = ((a[k] >> j) ^ a[k + j]) & m
            a[k] = a[k] ^ (t << j)
            a[k + j] = a[k + j] ^ t
            k = (k + j + 1) & ~j
        j >>= 1
        m = (m ^ (m << j)) & 0xFFFFFFFF if j else m
    return a


def planes_to_words(planes: torch.Tensor) -> torch.Tensor:
    """int32[8,16,W] planes -> int32[4,N] little-endian block words (word k
    of block n = bytes 4k..4k+3), N = 32W minor."""
    w = planes.shape[-1]
    out_rows = []
    for k in range(4):
        # bit r of word k of a block = byte (4k + r//8), bit (r%8)
        rows = [planes[r % 8, 4 * k + r // 8] for r in range(32)]
        tr = _transpose32(rows)  # tr[j] = word k of blocks (32w+j)
        out_rows.append(torch.stack(tr, dim=1).reshape(32 * w))
    return torch.stack(out_rows)


def words_to_planes(words: torch.Tensor) -> torch.Tensor:
    """int32[4,N] block words -> int32[8,16,W] planes (inverse)."""
    n = words.shape[-1]
    w = n // 32
    planes = [[None] * 16 for _ in range(8)]
    for k in range(4):
        rows = list(words[k].reshape(w, 32).T)
        tr = _transpose32(rows)  # tr[r] = plane of bit r of word k
        for r in range(32):
            planes[r % 8][4 * k + r // 8] = tr[r]
    return torch.stack([torch.stack(p) for p in planes])


def blocks_to_words(blocks: torch.Tensor) -> torch.Tensor:
    """uint8[N,16] -> int32[4,N] little-endian words (a bitcast and one
    transpose; the hosts and the card are little-endian)."""
    return blocks.contiguous().view(torch.int32).T


def words_to_blocks(words: torch.Tensor) -> torch.Tensor:
    """int32[4,N] -> uint8[N,16]."""
    return words.T.contiguous().view(torch.uint8)


def pack_planes(blocks: torch.Tensor) -> torch.Tensor:
    """uint8[N,16] -> int32[8,16,W] planes, N a multiple of 32: plane
    [b,p,w] bit j = bit b of byte p of block 32w+j."""
    return words_to_planes(blocks_to_words(blocks))


def unpack_planes(planes: torch.Tensor, n: int) -> torch.Tensor:
    """int32[8,16,W] -> uint8[n,16] (inverse of pack_planes)."""
    return words_to_blocks(planes_to_words(planes))[:n]


def key_planes(round_keys: np.ndarray) -> np.ndarray:
    """uint8[R+1,16] -> uint32[R+1,8,16] of 0/0xFFFFFFFF broadcast planes
    (host numpy; `utils.bytesio.u32_tensor` moves it to a device)."""
    rk = np.asarray(round_keys, np.uint8)
    bits = (rk[:, :, None] >> np.arange(8)) & 1  # [R+1,16,8]
    return bits.transpose(0, 2, 1).astype(np.uint32) * np.uint32(0xFFFFFFFF)


def key_planes_batch(rks: torch.Tensor) -> torch.Tensor:
    """uint8[B,R+1,16] round-key stack -> int32[B,(R+1)*128,1]: each row
    is key_planes of one key (0/-1 words), built on the stack's device so
    that only the round keys cross to it."""
    shifts = torch.arange(8, dtype=torch.uint8, device=rks.device)
    bits = (rks[..., None] >> shifts) & 1  # [B,R+1,16,8]
    planes = -(bits.transpose(2, 3).to(torch.int32))
    return planes.reshape(rks.shape[0], -1, 1)


def key_planes_packed(rks_stack: np.ndarray) -> np.ndarray:
    """uint8[B,R+1,16] per-message round keys -> uint32[R+1,8,16,W]
    lane-packed key planes: bit j of [r,b,p,w] = bit b of byte p of round
    key r of message 32w+j (B a multiple of 32).  The multikey form of
    key_planes, for engines whose 32 word lanes hold 32 messages."""
    rks_stack = np.asarray(rks_stack, np.uint8)
    if rks_stack.shape[0] % 32:
        raise ValueError("key_planes_packed needs a multiple of 32 keys")
    bits = np.unpackbits(rks_stack[:, :, :, None], axis=-1,
                         bitorder="little")  # [B,R+1,16,8]
    lanes = bits.transpose(1, 3, 2, 0)  # [R+1,8,16,B]
    packed = np.packbits(lanes, axis=-1, bitorder="little")
    return np.ascontiguousarray(packed).view(np.uint32)


# The wide message map of the lane-packed kernels (the JAX package's
# pallas_chain.wide_tile/wide_ok/wide_perm): with T = wide_tile(W), word
# w = i*T + wg holds messages i*32T + j*T + wg, so a word's 32 messages lie
# T apart.

def wide_tile(w: int) -> int:
    """Largest multiple-of-8 divisor of w up to 128 (0 if none)."""
    best = 0
    for t in range(8, min(w, 128) + 1, 8):
        if w % t == 0:
            best = t
    return best


def wide_ok(b: int) -> bool:
    """Whether a B-message batch takes the wide map: B = 32W with a tile of
    at least 32 words."""
    return b % 32 == 0 and wide_tile(b // 32) >= 32


def require_wide(name: str, b: int) -> None:
    """Raise ValueError unless a B-message batch takes the wide map."""
    if not wide_ok(b):
        raise ValueError(f"{name}: B={b} does not satisfy wide_ok")


def wide_perm(b: int) -> np.ndarray:
    """P[slot] = message index for slot = 32*word + j under the wide map.
    Pack keys with key_planes_packed(rks[wide_perm(B)]) for a wide wrapper."""
    w = b // 32
    t = wide_tile(w)
    word = np.arange(w)
    i, wg = word // t, word % t
    j = np.arange(32)
    return (i[:, None] * 32 * t + j[None, :] * t + wg[:, None]).reshape(-1)


def lane_round_keys(kpw: torch.Tensor) -> torch.Tensor:
    """Lane-packed key planes int32[R+1,8,16,W] (key_planes_packed) -> each
    lane's round keys uint8[R+1,B,16], B = 32W."""
    kpw = kpw.view(torch.int32)
    return torch.stack([unpack_planes(k, 32 * kpw.shape[3]) for k in kpw])


@functools.lru_cache(maxsize=None)
def _perm_index(name: str, device: torch.device) -> torch.Tensor:
    perm = {"shift": SHIFT_PERM, "inv_shift": INV_SHIFT_PERM}[name]
    return torch.as_tensor(perm, dtype=torch.int64, device=device)


def _roll_rows(x: torch.Tensor, k: int) -> torch.Tensor:
    """Rotate byte positions within each column: p=4c+r -> 4c+(r+k)%4.
    x: [16, W] indexed by byte position."""
    w = x.shape[-1]
    return torch.roll(x.reshape(4, 4, w), -k, dims=1).reshape(16, w)


def _mix_columns_planes(p):
    a1 = [_roll_rows(x, 1) for x in p]
    a2 = [_roll_rows(x, 2) for x in p]
    a3 = [_roll_rows(x, 3) for x in p]
    xt = _xtime_planes(p)
    xt1 = _xtime_planes(a1)
    return [xt[b] ^ xt1[b] ^ a1[b] ^ a2[b] ^ a3[b] for b in range(8)]


def _inv_mix_columns_planes(p):
    """InvMixColumns = MixColumns ∘ (column multiply by d(z) = {04}z² +
    {05}), since c(z)·d(z) = c⁻¹(z) mod z⁴+1 — 60 XOR vs 89 direct."""
    x4 = _xtime_planes(_xtime_planes(p))
    pre = [p[b] ^ x4[b] ^ _roll_rows(x4[b], 2) for b in range(8)]
    return _mix_columns_planes(pre)


def _round_key(kp: torch.Tensor, r: int, b: int) -> torch.Tensor:
    """Key planes of round r, bit b: [16, 1] broadcast over the words for
    one key (kp [R+1,8,16]), or [16, W] for a key per word or per lane
    (kp [R+1,8,16,W])."""
    k = kp[r, b]
    return k[:, None] if kp.dim() == 3 else k


def encrypt_planes(kp: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Bitsliced encryption: kp int32[R+1,8,16] (one key) or
    [R+1,8,16,W] (see _round_key), planes int32[8,16,W]."""
    rounds = kp.shape[0] - 1
    shift = _perm_index("shift", planes.device)
    p = [planes[b] ^ _round_key(kp, 0, b) for b in range(8)]
    for r in range(1, rounds + 1):
        p = sbox_planes(p, True)
        p = [x[shift] for x in p]
        if r != rounds:
            p = _mix_columns_planes(p)
        p = [p[b] ^ _round_key(kp, r, b) for b in range(8)]
    return torch.stack(p)


def encrypt_planes_multikey(kpw: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Bitsliced encryption with per-lane keys: kpw int32[R+1,8,16,W] from
    key_planes_packed, planes int32[8,16,W]."""
    return encrypt_planes(kpw, planes)


def decrypt_planes(kp: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Bitsliced decryption: kp as for encrypt_planes, planes
    int32[8,16,W]."""
    rounds = kp.shape[0] - 1
    inv_shift = _perm_index("inv_shift", planes.device)
    p = [planes[b] ^ _round_key(kp, rounds, b) for b in range(8)]
    for r in range(rounds - 1, -1, -1):
        p = [x[inv_shift] for x in p]
        p = sbox_planes(p, False)
        p = [x ^ _round_key(kp, r, b) for b, x in enumerate(p)]
        if r != 0:
            p = _inv_mix_columns_planes(p)
    return torch.stack(p)
