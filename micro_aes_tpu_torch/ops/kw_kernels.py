"""K16: the RFC 3394 key-wrap wheel over B = 32W independent messages, each
under its own key-encryption key, 32 messages per int32 plane word.

  kw_packed(kpw, data, unwrap=False)          the natural message map
  kw_packed_fused(kpw_w, data, unwrap=False)  the wide map (the JAX package's
                                              kw_packed_fused contract)

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

Each wrapper dispatches on the device of its data: on CUDA it launches the
hand-written kernel (csrc/kw_wheel.cu) or raises, on the CPU it runs the
plain PyTorch version (a 6n-step loop over the byte cipher of core/cipher
with each lane's round keys unpacked from the key planes, as K11's and
K15's plain versions do; the wide form gathers the data into slot order,
runs the natural one and scatters the result back).  There is no fallback
from CUDA to the plain versions.
"""
from __future__ import annotations

import torch

from ..core.bitslice import lane_round_keys, require_wide, wide_perm, wide_tile
from ..core.cipher import decrypt_blocks, encrypt_blocks
from . import _build
from .seal_kernels import _WORD_DTYPES, _device

HB = 8  # a semiblock
ICV = 0xA6


def kw_packed_plain(kpw, data, unwrap: bool = False):
    """Plain PyTorch version of kw_packed (same contract)."""
    rk = lane_round_keys(kpw)  # uint8[R+1,B,16]
    b = data.shape[0]
    if unwrap:
        n = data.shape[1] - 1
        a, r = data[:, 0], data[:, 1:].clone()
    else:
        n = data.shape[1]
        a, r = torch.full((b, HB), ICV, dtype=torch.uint8, device=data.device), data.clone()
    # be[t] = BE64(t), the step count XORed into A, for t = 0..6n
    be = torch.tensor([list(t.to_bytes(HB, "big")) for t in range(6 * n + 1)],
                      dtype=torch.uint8, device=data.device)
    for s in range(6 * n):
        if unwrap:  # A ^= t before the inverse cipher (micro_aes.c:1877)
            i, t = (6 * n - 1 - s) % n, 6 * n - s
            y = decrypt_blocks(rk, torch.cat([a ^ be[t], r[:, i]], dim=1))
            a = y[:, :HB]
        else:
            i, t = s % n, s + 1
            y = encrypt_blocks(rk, torch.cat([a, r[:, i]], dim=1))
            a = y[:, :HB] ^ be[t]
        r[:, i] = y[:, HB:]
    return torch.cat([a[:, None], r], dim=1)


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
