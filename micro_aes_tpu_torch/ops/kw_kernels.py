"""K16: the RFC 3394 key-wrap wheel over B = 32W independent messages, each
under its own key-encryption key, 32 messages per int32 plane word.

  kw_packed(kpw, data, unwrap=False)          the natural message map
  kw_packed_fused(kpw_w, data, unwrap=False)  the wide map (the JAX package's
                                              kw_packed_fused contract)
  kw_wheel_ragged(kpw15, desc, data, unwrap=False)
                                              words of different n and KEK
                                              sizes in one launch (ops/ragged)

Wrapping, data is uint8[B,n,8] secrets; unwrapping, uint8[B,n+1,8] wrapped
inputs (A || R).  Either way the result is uint8[B,n+1,8], A' || R', after
the 6n wheel steps of micro_aes.c:1829-1893; the caller checks unwrap's A'
against 0xA6.  n >= 2.  kpw int32 (or uint32) [R+1,8,16,W] lane-packed key
planes (core/bitslice.key_planes_packed): for kw_packed in message order,
for kw_packed_fused packed from rks[wide_perm(B)], with B satisfying
wide_ok(B).  data and the result stay in natural message order.

The wide map (core/bitslice's wide_tile, wide_ok and wide_perm; the JAX
package's ops/pallas_chain.py:93-119) puts message i*32T + j*T + wg in bit j of word
i*T + wg, T = wide_tile(W): a word's 32 messages lie T apart.  K14
(ops/chain_kernels) uses it too.

kw_wheel_ragged takes the rows of a whole batch packed by ops/ragged's
layout: data uint8[N] holds each message's row of n+1 semiblocks (to wrap,
its n semiblocks after an unused first one; to unwrap, the wrapped input),
kpw15 int32[15,8,16,W] the words' key planes padded to 15 round keys
(ragged_key_planes) and desc int64[W,4] the words' (n, rounds | live << 8,
msg0, off); the result is uint8[N], each row A' || R'.  Every word has n >=
2.  kw_packed and kw_packed_fused launch the same kernel with the
descriptor of every word computed from (n, rounds, tile).

Each wrapper dispatches on the device of its data: on CUDA it launches the
hand-written kernel (csrc/kw_wheel.cu) or raises, on the CPU it runs the
plain PyTorch version (a 6n-step loop over the byte cipher of core/cipher
with each lane's round keys unpacked from the key planes, as K11's and
K15's plain versions do; the wide form gathers the data into slot order,
runs the natural one and scatters the result back).  There is no fallback
from CUDA to the plain versions.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.bitslice import lane_round_keys, require_wide, wide_perm, wide_tile
from ..core.cipher import decrypt_blocks, encrypt_blocks
from . import _build
from .ragged import aligned, check_desc, desc_array
from .seal_kernels import _WORD_DTYPES, _device

HB = 8  # a semiblock
ICV = 0xA6


def _wheel_plain(rk, a, r, n, unwrap: bool):
    """The 6n wheel steps of B messages on the byte cipher: rk uint8[R+1,B,16]
    round keys, a uint8[B,8] the start of A, r uint8[B,nmax,8] the
    semiblocks, n int64[B] each message's n (nmax >= n; a message whose 6n
    steps are done stops) -> uint8[B,nmax+1,8], A' || R'."""
    b = a.shape[0]
    rows = torch.arange(b, device=a.device)
    steps = 6 * n
    shifts = torch.arange(56, -8, -8, device=a.device)
    for s in range(int(steps.max()) if b else 0):
        on = (s < steps)[:, None]
        if unwrap:  # A ^= t before the inverse cipher (micro_aes.c:1877)
            i, t = (steps - 1 - s) % n, steps - s
        else:
            i, t = s % n, torch.full_like(n, s + 1)
        be = ((t[:, None] >> shifts) & 0xFF).to(torch.uint8)  # BE64(t)
        ri = r[rows, i]
        if unwrap:
            y = decrypt_blocks(rk, torch.cat([a ^ be, ri], dim=1))
            a = torch.where(on, y[:, :HB], a)
        else:
            y = encrypt_blocks(rk, torch.cat([a, ri], dim=1))
            a = torch.where(on, y[:, :HB] ^ be, a)
        r[rows, i] = torch.where(on, y[:, HB:], ri)
    return torch.cat([a[:, None], r], dim=1)


def kw_packed_plain(kpw, data, unwrap: bool = False):
    """Plain PyTorch version of kw_packed (same contract)."""
    rk = lane_round_keys(kpw)  # uint8[R+1,B,16]
    b = data.shape[0]
    if unwrap:
        a, r = data[:, 0], data[:, 1:].clone()
    else:
        a, r = torch.full((b, HB), ICV, dtype=torch.uint8, device=data.device), data.clone()
    n = torch.full((b,), r.shape[1], dtype=torch.int64, device=data.device)
    return _wheel_plain(rk, a, r, n, unwrap)


def kw_packed_fused_plain(kpw_w, data, unwrap: bool = False):
    """Plain PyTorch version of kw_packed_fused (same contract)."""
    b = data.shape[0]
    require_wide("kw_packed_fused", b)
    perm = torch.as_tensor(wide_perm(b), device=data.device)
    out = torch.empty((b, data.shape[1] + (0 if unwrap else 1), HB), dtype=torch.uint8,
                      device=data.device)
    out[perm] = kw_packed_plain(kpw_w, data[perm], unwrap)
    return out


def _check(name, kpw, data, unwrap: bool):
    """Raise on what the kernel does not take -> (rounds, W, n)."""
    if kpw.dim() != 4 or kpw.shape[1:3] != (8, 16) or kpw.shape[0] - 1 not in (10, 12, 14):
        raise ValueError(f"{name}: kpw shape {tuple(kpw.shape)}")
    if kpw.dtype not in _WORD_DTYPES:
        raise TypeError(f"{name}: kpw must be int32 or uint32, got {kpw.dtype}")
    w = kpw.shape[3]
    if data.dim() != 3 or data.shape[0] != 32 * w or data.shape[2] != HB:
        raise ValueError(f"{name}: data shape {tuple(data.shape)} for W={w}")
    n = data.shape[1] - (1 if unwrap else 0)
    if n < 2:
        raise ValueError(f"{name}: {n} semiblocks; the wheel needs at least 2")
    if data.dtype != torch.uint8:
        raise TypeError(f"{name}: data must be uint8, got {data.dtype}")
    for arg, t in (("kpw", kpw), ("data", data)):
        if t.device != data.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {data.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    return kpw.shape[0] - 1, w, n


def _launch(name, kpw, data, unwrap: bool, tile: int):
    rounds, w, n = _check(name, kpw, data, unwrap)
    out = torch.empty((data.shape[0], n + 1, HB), dtype=torch.uint8, device=data.device)
    if w:
        data = aligned(data, HB)
        lib = _build.load()
        with torch.cuda.device(data.device):
            stream = torch.cuda.current_stream(data.device).cuda_stream
            err = lib.micro_aes_kw_wheel(kpw.data_ptr(), data.data_ptr(), out.data_ptr(),
                                         int(bool(unwrap)), rounds, w, n, tile, stream)
        _build.check_launch(name, err)
    return out, w > 0


def kw_packed(kpw, data, unwrap: bool = False):
    """K16 in the natural map: kpw [R+1,8,16,W] (message 32w+j in bit j of
    word w), data uint8[B,n,8] (wrap) or uint8[B,n+1,8] (unwrap), B = 32W ->
    uint8[B,n+1,8]."""
    if _device("kw_packed", data).type == "cpu":
        return kw_packed_plain(kpw, data, unwrap)
    out, launched = _launch("kw_packed", kpw, data, unwrap, 1)
    kw_packed.launches += launched
    return out


kw_packed.launches = 0


def kw_packed_fused(kpw_w, data, unwrap: bool = False):
    """K16 in the wide map: as kw_packed, with kpw_w packed from
    rks[wide_perm(B)] and B satisfying wide_ok(B) (ValueError otherwise)."""
    require_wide("kw_packed_fused", data.shape[0])
    if _device("kw_packed_fused", data).type == "cpu":
        return kw_packed_fused_plain(kpw_w, data, unwrap)
    out, launched = _launch("kw_packed_fused", kpw_w, data, unwrap,
                            wide_tile(data.shape[0] // 32))
    kw_packed_fused.launches += launched
    return out


kw_packed_fused.launches = 0


# -- the ragged batch: one launch over words of different n and KEK sizes ----

def kw_wheel_ragged_plain(kpw15, desc, data, unwrap: bool = False):
    """Plain PyTorch version of kw_wheel_ragged (same contract): the live
    slots of each key size's words through one masked wheel of the byte
    cipher (_wheel_plain), each message stopping after its own 6n steps."""
    d = desc_array(desc)
    out = torch.zeros_like(data)
    live = d[:, 1] >> 8
    j = np.arange(32)
    for rounds in sorted({int(x) for x in d[live > 0, 1] & 0xFF}):
        words = np.flatnonzero(((d[:, 1] & 0xFF) == rounds) & (live > 0))
        on = (j[None, :] < live[words, None]).reshape(-1)
        n = np.repeat(d[words, 0], 32)[on]
        row = (n + 1) * HB
        base = np.repeat(d[words, 3], 32)[on] + np.tile(j, len(words))[on] * row
        span = np.arange(int(row.max()))
        inside = span[None, :] < row[:, None]
        idx = torch.from_numpy(np.where(inside, base[:, None] + span[None, :], 0)).to(data.device)
        inside_t = torch.from_numpy(inside).to(data.device)
        rows = (data[idx] * inside_t).reshape(len(n), -1, HB)
        rk = lane_round_keys(kpw15[:rounds + 1, :, :, torch.from_numpy(words).to(kpw15.device)])
        rk = rk[:, torch.from_numpy(np.flatnonzero(on)).to(rk.device)]
        a = rows[:, 0] if unwrap else torch.full_like(rows[:, 0], ICV)
        y = _wheel_plain(rk, a, rows[:, 1:].clone(), torch.from_numpy(n).to(data.device), unwrap)
        out[idx[inside_t]] = y.reshape(len(n), -1)[inside_t]
    return out


def kw_wheel_ragged(kpw15, desc, data, unwrap: bool = False):
    """K16 over a whole ragged batch in one launch: kpw15 int32[15,8,16,W],
    desc int64[W,4] (host array or tensor), data uint8[N] packed rows ->
    uint8[N] (module docstring)."""
    d = desc_array(desc)
    if data.dim() != 1 or data.dtype != torch.uint8:
        raise ValueError(f"kw_wheel_ragged: data must be flat uint8, got {data.dtype} "
                         f"{tuple(data.shape)}")
    if kpw15.shape != (15, 8, 16, d.shape[0]) or kpw15.dtype not in _WORD_DTYPES:
        raise ValueError(f"kw_wheel_ragged: kpw15 {kpw15.dtype} {tuple(kpw15.shape)} for "
                         f"{d.shape[0]} words")
    check_desc("kw_wheel_ragged", d, None, data.numel(), lambda n: (n + 1) * HB)
    if ((d[:, 1] >> 8 > 0) & (d[:, 0] < 2)).any():
        raise ValueError("kw_wheel_ragged: a word has fewer than 2 semiblocks")
    if _device("kw_wheel_ragged", data).type == "cpu":
        return kw_wheel_ragged_plain(kpw15, d, data, unwrap)
    if kpw15.device != data.device or not kpw15.is_contiguous() or not data.is_contiguous():
        raise ValueError("kw_wheel_ragged: kpw15 and data must be contiguous on one device")
    out = torch.empty_like(data)
    if d.shape[0]:
        data = aligned(data, HB)
        desc_t = torch.from_numpy(d).to(data.device)
        lib = _build.load()
        with torch.cuda.device(data.device):
            stream = torch.cuda.current_stream(data.device).cuda_stream
            err = lib.micro_aes_kw_ragged(kpw15.data_ptr(), desc_t.data_ptr(), data.data_ptr(),
                                          out.data_ptr(), int(bool(unwrap)), d.shape[0], stream)
        _build.check_launch("kw_wheel_ragged", err)
        kw_wheel_ragged.launches += 1
    return out


kw_wheel_ragged.launches = 0
