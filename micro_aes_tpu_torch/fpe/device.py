"""Batched FPE on the device: FF1/FF3/FF3-1 over many tokens at once.

The host paths (ff1.py / ff3.py) run one token at a time.  Here N tokens of
one length run through each Feistel round together, on the request's
device.  The reference's arbitrary-precision numeral arithmetic
(numRadix/strRadix/numstrAdd/numstrSub, micro_aes.c:2039-2088) becomes:

* NUM_radix(digits) -> bytes: one small product against a precomputed
  power table (byte limbs of radix^j) followed by one base-256 carry scan;
* bytes -> digits mod radix^m (the y of each Feistel round, SP 800-38G step
  6c): a product against digit vectors of 256^j mod radix^m, fused with the
  numstrAdd/Sub, so that one base-radix carry scan yields (NUM(A) ± y) mod
  radix^m directly (the mod is the dropped final carry).  The products are
  float64 and exact: every sum is at most 255 * 255 times the digit or
  byte count, far below 2^53;
* the per-round PRF (the CBC-MAC over P || Q, micro_aes.c:2091-2114): E(P)
  once, then a short chain of batched single-block encrypts of Q's blocks,
  and the S-expansion blocks E(R ^ [j]) as one more batched encrypt.

Every batched encrypt runs on K2 (ops/cipher_kernel.cipher_planes, the
bitsliced plane cipher; its plain version on the CPU): the batch is padded
to a multiple of 32 tokens, so each encrypt is a whole number of 32-block
plane words.  The Feistel runs as a Python loop over double rounds.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.bitslice import key_planes, pack_planes, unpack_planes
from ..core.cipher import encrypt_blocks
from ..core.keyschedule import expand_key
from ..errors import DecryptionError, EncryptionError
from ..ops.cipher_kernel import cipher_planes
from ..utils.bytesio import u32_tensor
from ..utils.keycache import key_cache
from .alphabet import resolve_alphabet
from .ff3 import _split_tweak

# The products hold byte times byte times digit count exactly; every
# reference alphabet (radix <= 95) qualifies, and wider alphabets take the
# host path.
MAX_DEVICE_RADIX = 256


def _enc_batch(kp: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """E_K of uint8[B,16] blocks, B a multiple of 32, on K2."""
    return unpack_planes(cipher_planes(kp, pack_planes(blocks)), blocks.shape[0])


# ---------------------------------------------------------------------------
# Power tables (host ints)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=512)
def _num_table(radix: int, length: int, nbytes: int, msd_first: bool):
    """U[j, l] = byte l (LSB first) of radix^e(j), e = length-1-j for
    MSD-first digit input, j for LSD-first.  digits @ U followed by a
    base-256 carry scan is NUM_radix (micro_aes.c:2039-2052)."""
    u = np.zeros((length, nbytes), np.int32)
    for j in range(length):
        e = length - 1 - j if msd_first else j
        p = pow(radix, e)
        for l in range(nbytes):
            u[j, l] = (p >> (8 * l)) & 0xFF
    return u


@functools.lru_cache(maxsize=512)
def _ydig_table(radix: int, nbytes: int, m: int):
    """V[j, p] = digit p (LSD first) of 256^(nbytes-1-j) mod radix^m, so
    S_bytes(BE) @ V accumulates y mod radix^m in positional radix form
    (normalized by the same carry scan that applies numstrAdd/Sub)."""
    mod = pow(radix, m)
    v = np.zeros((nbytes, m), np.int32)
    for j in range(nbytes):
        p = pow(256, nbytes - 1 - j, mod)
        for k in range(m):
            v[j, k] = p % radix
            p //= radix
    return v


def _product(x: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """x [B, L] (small non-negative ints) @ table [L, M] -> int32[B, M], as
    a float64 product (exact: every sum is far below 2^53; torch has no
    integer product on CUDA)."""
    t = torch.from_numpy(table.astype(np.float64)).to(x.device)
    return (x.to(torch.float64) @ t).to(torch.int32)


def _carry_scan(acc: torch.Tensor, base: int) -> torch.Tensor:
    """Normalize positional LSD-first int32 values [B, L] into digits in
    [0, base); the final carry is dropped (the result is mod base^L).  Floor
    division makes one scan serve add and subtract (decryption's values go
    negative)."""
    carry = torch.zeros_like(acc[:, 0])
    out = []
    for k in range(acc.shape[1]):
        t = acc[:, k] + carry
        carry = torch.div(t, base, rounding_mode="floor")
        out.append(t - carry * base)
    return torch.stack(out, dim=1)


def _num_bytes(h: torch.Tensor, radix: int, nbytes: int, msd_first: bool) -> torch.Tensor:
    """NUM_radix as a product and a carry scan -> LSB-first byte limbs
    [B, nbytes]."""
    return _carry_scan(_product(h, _num_table(radix, h.shape[1], nbytes, msd_first)), 256)


# ---------------------------------------------------------------------------
# The wire: radix <= 16 digits travel two to a byte
# ---------------------------------------------------------------------------


def _wire_packed(radix: int) -> bool:
    """Digit matrices of radix <= 16 cross to and from the device two digits
    to a byte (radix 10, the reference's default alphabet, micro_aes.c:
    2008-2013, qualifies); the pack and unpack are a shift and a mask."""
    return radix <= 16


def _unpack_nibbles_t(xw: torch.Tensor, n: int) -> torch.Tensor:
    """uint8[B, ceil(n/2)] little-endian nibble wire -> int32[B, n]
    digits."""
    lo = (xw & 0xF).to(torch.int32)
    hi = (xw >> 4).to(torch.int32)
    return torch.stack([lo, hi], dim=-1).reshape(xw.shape[0], -1)[:, :n]


def _pack_nibbles_t(d: torch.Tensor) -> torch.Tensor:
    """int32[B, n] digits (< 16) -> uint8[B, ceil(n/2)] nibble wire."""
    if d.shape[1] % 2:
        d = torch.nn.functional.pad(d, (0, 1))
    dd = d.to(torch.uint8).reshape(d.shape[0], -1, 2)
    return dd[..., 0] | (dd[..., 1] << 4)


def _pack_nibbles_np(x: np.ndarray) -> np.ndarray:
    n = x.shape[1]
    if n % 2:
        x = np.concatenate([x, np.zeros((x.shape[0], 1), np.uint8)], axis=1)
    xx = x.reshape(x.shape[0], -1, 2)
    return xx[..., 0] | (xx[..., 1] << 4)


def _unpack_nibbles_np(xw: np.ndarray, n: int) -> np.ndarray:
    d = np.empty((xw.shape[0], xw.shape[1] * 2), np.uint8)
    d[:, 0::2] = xw & 0xF
    d[:, 1::2] = xw >> 4
    return d[:, :n]


def _to_wire(out: torch.Tensor, radix: int) -> torch.Tensor:
    """int32[B, n] digits -> the wire (uint8: nibbles or one digit a
    byte)."""
    return _pack_nibbles_t(out) if _wire_packed(radix) else out.to(torch.uint8)


def _from_wire(x: torch.Tensor, radix: int, n: int) -> torch.Tensor:
    return _unpack_nibbles_t(x, n) if _wire_packed(radix) else x.to(torch.int32)


# ---------------------------------------------------------------------------
# FF1 (SP 800-38G §5.1; reference FF1_cipher micro_aes.c:2117-2147)
# ---------------------------------------------------------------------------


def _ff1_core(rks, kp, tweak1, x, radix: int, n: int, t: int, encrypt: bool):
    """FF1 over a wire batch x uint8[B, wire] (B a multiple of 32) on x's
    device -> the output wire."""
    u = n // 2
    v = n - u
    b = (math.ceil(v * math.log2(radix)) + 7) // 8
    d = 4 * ((b + 3) // 4) + 4
    qpad = (-t - b - 1) % 16
    nq = (t + qpad + 1 + b) // 16
    B = x.shape[0]
    dev = x.device
    x = _from_wire(x, radix, n)

    p_blk = np.frombuffer(
        bytes([1, 2, 1]) + radix.to_bytes(3, "big") + bytes([10, u % 256])
        + n.to_bytes(4, "big") + t.to_bytes(4, "big"), np.uint8)
    e_p = encrypt_blocks(rks, torch.from_numpy(p_blk.copy()).to(dev)[None])  # CBC state after P
    head = torch.cat([tweak1, torch.zeros(qpad, dtype=torch.uint8, device=dev)])
    nxb = (d - 1) // 16  # S-expansion blocks E(R ^ [j]), j = 1..nxb
    j_blocks = torch.from_numpy(np.frombuffer(
        b"".join(j.to_bytes(16, "big") for j in range(1, nxb + 1)), np.uint8)
        .reshape(nxb, 16).copy()).to(dev)

    def prf_y(half, m: int, round_i: int):
        """One round's y accumulated as unnormalized radix-m digits."""
        numb = _num_bytes(half, radix, b, msd_first=True)  # LSB-first
        row = torch.cat([head, torch.tensor([round_i], dtype=torch.uint8, device=dev)])
        q = torch.cat([row.expand(B, -1), numb.flip(1).to(torch.uint8)], dim=1)
        q = q.reshape(B, nq, 16)
        acc = e_p.expand(B, 16)
        for k in range(nq):
            acc = _enc_batch(kp, acc ^ q[:, k])
        s = acc
        if nxb:
            xs = acc[:, None, :] ^ j_blocks[None]
            ext = _enc_batch(kp, xs.reshape(B * nxb, 16))
            s = torch.cat([acc, ext.reshape(B, nxb * 16)], dim=1)
        return _product(s[:, :d], _ydig_table(radix, d, m))

    def enc_round(a, bb, m: int, i: int):
        c = _carry_scan(a.flip(1) + prf_y(bb, m, i), radix)
        return bb, c.flip(1)

    def dec_round(a, bb, m: int, i: int):
        c = _carry_scan(bb.flip(1) - prf_y(a, m, i), radix)
        return c.flip(1), a

    # a round pair restores the (u, v) half shapes
    a, bb = x[:, :u], x[:, u:]
    for j in range(5):
        if encrypt:
            a, bb = enc_round(a, bb, u, 2 * j)
            a, bb = enc_round(a, bb, v, 2 * j + 1)
        else:
            a, bb = dec_round(a, bb, v, 9 - 2 * j)
            a, bb = dec_round(a, bb, u, 8 - 2 * j)
    return _to_wire(torch.cat([a, bb], dim=1), radix)


# ---------------------------------------------------------------------------
# FF3 / FF3-1 (SP 800-38G §5.2; reference FF3_cipher micro_aes.c:2218-2248)
# ---------------------------------------------------------------------------


def _ff3_core(kp_rev, tl1, tr1, x, radix: int, n: int, encrypt: bool):
    """FF3 over a wire batch x uint8[B, wire] (B a multiple of 32).  The
    halves live MSD-first at the boundary, but every NUM/STR in the spec
    reverses them first: NUM(REV(h)) = sum h[j]*radix^j, the boundary array
    read LSD-first.  So the halves are used as they are, with LSD-first
    tables."""
    u, v = (n + 1) // 2, n - (n + 1) // 2
    B = x.shape[0]
    x = _from_wire(x, radix, n)

    def round_y(half, m: int, even: bool, i: int):
        numb = _num_bytes(half, radix, 12, msd_first=False)
        w = tr1 if even else tl1
        w = torch.cat([w[:3], w[3:] ^ i])
        p = torch.cat([w.expand(B, 4), numb.flip(1).to(torch.uint8)], dim=1)
        s = _enc_batch(kp_rev, p.flip(1)).flip(1)  # the reference's byte order
        return _product(s, _ydig_table(radix, 16, m))

    def enc_round(a, bb, m: int, even: bool, i: int):
        return bb, _carry_scan(a + round_y(bb, m, even, i), radix)

    def dec_round(a, bb, m: int, even: bool, i: int):
        return _carry_scan(bb - round_y(a, m, even, i), radix), a

    a, bb = x[:, :u], x[:, u:]
    for j in range(4):
        if encrypt:
            a, bb = enc_round(a, bb, u, True, 2 * j)
            a, bb = enc_round(a, bb, v, False, 2 * j + 1)
        else:
            a, bb = dec_round(a, bb, v, False, 7 - 2 * j)
            a, bb = dec_round(a, bb, u, True, 6 - 2 * j)
    return _to_wire(torch.cat([a, bb], dim=1), radix)


# ---------------------------------------------------------------------------
# Batched front end (groups tokens by length: one run per group)
# ---------------------------------------------------------------------------


@key_cache(maxsize=64)
def _rks(key: bytes, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(expand_key(key))).to(device)


@key_cache(maxsize=64)
def _kp(key: bytes, device: torch.device) -> torch.Tensor:
    return u32_tensor(key_planes(expand_key(key)), device)


@functools.lru_cache(maxsize=64)
def _ascii_luts(chars: str):
    """(char->digit, digit->char) numpy tables for pure-ASCII alphabets, or
    None: the vectorized codec of the batch path (the per-character
    chars.index of FPE_cipher's boundary, micro_aes.c:2287-2303, would cost
    more host time than the device work)."""
    if any(ord(c) > 126 for c in chars):
        return None
    enc = np.full(128, -1, np.int32)
    for i, c in enumerate(chars):
        enc[ord(c)] = i
    dec = np.frombuffer(chars.encode("ascii"), np.uint8)
    return enc, dec


# Batches above one chunk run chunk by chunk, so that the device's working
# set stays bounded however large the batch is.
FPE_CHUNK = 32768


def _map_chunks(body, x2: torch.Tensor) -> torch.Tensor:
    """Run `body` over FPE_CHUNK-row chunks of x2 [B, wire] (B and FPE_CHUNK
    multiples of 32) and join the outputs."""
    return torch.cat([body(x2[i: i + FPE_CHUNK]) for i in range(0, x2.shape[0], FPE_CHUNK)])


def _dispatch_digits(key: bytes, tweak: bytes, x: np.ndarray, radix: int, n: int,
                     method: str, encrypt: bool, device) -> np.ndarray:
    """Batched FPE over a digit matrix uint8[b, n] on `device`: the batch
    padded to a multiple of 32 with copies of row 0 (the PRF then runs on
    K2's whole plane words), the digits shipped packed (two a byte for
    radix <= 16, else one a byte)."""
    dev = torch.device(device)
    b = x.shape[0]
    xu = np.ascontiguousarray(x, np.uint8)

    if method == "ff1":
        tw1 = torch.from_numpy(np.frombuffer(tweak, np.uint8).copy()).to(dev)
        rks, kp = _rks(key, dev), _kp(key, dev)

        def body(c):
            return _ff1_core(rks, kp, tw1, c, radix, n, len(tweak), encrypt)
    elif method in ("ff3", "ff3-1"):
        tl, tr = _split_tweak(tweak)
        kp_rev = _kp(bytes(reversed(key)), dev)
        tl1 = torch.from_numpy(np.frombuffer(tl, np.uint8).copy()).to(dev)
        tr1 = torch.from_numpy(np.frombuffer(tr, np.uint8).copy()).to(dev)

        def body(c):
            return _ff3_core(kp_rev, tl1, tr1, c, radix, n, encrypt)
    else:
        raise ValueError(f"unknown FPE method {method!r}")

    bp = b + ((-b) % 32)
    if bp != b:
        xu = np.concatenate([xu, np.broadcast_to(xu[:1], (bp - b, n))])
    packed = _wire_packed(radix)
    wire = _pack_nibbles_np(xu) if packed else xu
    res = _map_chunks(body, torch.from_numpy(np.ascontiguousarray(wire)).to(dev))[:b]
    res = res.cpu().numpy()
    return _unpack_nibbles_np(res, n) if packed else res


def _digits_call(key, tweak, digits, radix: int, method: str, encrypt: bool, device):
    err = EncryptionError if encrypt else DecryptionError
    d = np.asarray(digits)
    if d.ndim != 2:
        raise err("digits must be a [B, n] matrix")
    if not 2 <= radix <= MAX_DEVICE_RADIX:
        raise err(f"radix {radix} outside device range")
    return _dispatch_digits(bytes(key), bytes(tweak) if tweak else b"", d, radix,
                            d.shape[1], method.lower(), encrypt, device)


def fpe_encrypt_digits(key, tweak, digits: np.ndarray, radix: int, method: str = "ff1", *,
                       device="cuda") -> np.ndarray:
    """Encrypt a uint8[B, n] digit matrix (values in [0, radix)) on
    `device` in one batched run, without the string boundary of
    fpe_encrypt_batch."""
    return _digits_call(key, tweak, digits, radix, method, True, device)


def fpe_decrypt_digits(key, tweak, digits: np.ndarray, radix: int, method: str = "ff1", *,
                       device="cuda") -> np.ndarray:
    """Inverse of fpe_encrypt_digits."""
    return _digits_call(key, tweak, digits, radix, method, False, device)


def _fpe_batch(key, tweak, tokens, alphabet, method: str, encrypt: bool,
               device) -> list[str]:
    alpha = resolve_alphabet(alphabet)
    method = method.lower()
    err = EncryptionError if encrypt else DecryptionError
    if alpha.radix > MAX_DEVICE_RADIX:
        from . import fpe_decrypt, fpe_encrypt  # the host path, a token at a time

        fn = fpe_encrypt if encrypt else fpe_decrypt
        return [fn(key, tweak, tok, alpha, method, device=device) for tok in tokens]

    key = bytes(key)
    tweak = bytes(tweak) if tweak else b""
    tokens = [str(t) for t in tokens]
    for tok in tokens:
        if len(tok) < alpha.min_len:
            raise err(f"input shorter than MINLEN={alpha.min_len}")
        if method in ("ff3", "ff3-1") and len(tok) > alpha.max_len_ff3():
            raise err(f"input longer than MAXLEN={alpha.max_len_ff3()}")

    groups: dict[int, list[int]] = {}
    for i, tok in enumerate(tokens):
        groups.setdefault(len(tok), []).append(i)
    luts = _ascii_luts(alpha.chars)

    out: list[str | None] = [None] * len(tokens)
    for n, idxs in groups.items():
        joined = "".join(tokens[i] for i in idxs)
        if luts is not None and joined.isascii():
            codes = np.frombuffer(joined.encode("ascii"), np.uint8)
            x = luts[0][codes].reshape(len(idxs), n)
            if (x < 0).any():
                raise err("invalid character for alphabet")
        else:
            try:
                x = np.asarray([alpha.encode(tokens[i]) for i in idxs], np.int32)
            except EncryptionError:
                raise err("invalid character for alphabet")
        res = _dispatch_digits(key, tweak, x, alpha.radix, n, method, encrypt, device)
        if luts is not None:
            flat = luts[1][res.reshape(-1)].tobytes().decode("ascii")
            for k, i in enumerate(idxs):
                out[i] = flat[k * n: (k + 1) * n]
        else:
            for k, i in enumerate(idxs):
                out[i] = alpha.decode(res[k])
    return out  # type: ignore[return-value]


def fpe_encrypt_batch(key, tweak, plaintexts, alphabet="digits", method: str = "ff1", *,
                      device="cuda") -> list[str]:
    """AES_FPE_encrypt over N tokens, one batched run per distinct token
    length (micro_aes.c:2326-2331, batched)."""
    return _fpe_batch(key, tweak, plaintexts, alphabet, method, True, device)


def fpe_decrypt_batch(key, tweak, ciphertexts, alphabet="digits", method: str = "ff1", *,
                      device="cuda") -> list[str]:
    """AES_FPE_decrypt over N tokens, batched (micro_aes.c:2343-2348)."""
    return _fpe_batch(key, tweak, ciphertexts, alphabet, method, False, device)
