"""K13: the lane-packed serial chains over B = 32W independent messages, each
under its own key, 32 messages per int32 plane word.

  chain_packed_fused("cbc", kpw, ivs, blocks)  y_t = E(y_{t-1} ^ x_t)
  chain_packed_fused("cfb", kpw, ivs, blocks)  y_t = E(y_{t-1}) ^ x_t
  ofb_packed_fused(kpw, ivs, nb)               y_t = E(y_{t-1})
  cbcmac_packed_fused(kpw, init, blocks, nvalid)
                                               m = E(m ^ x_t) while t < nvalid
                                               of the message; returns m

with y_{-1} = the message's iv (or init).  kpw int32 (or uint32)
[R+1,8,16,W] lane-packed key planes (bit j of word w = message 32w+j,
core/bitslice.key_planes_packed), ivs/init uint8[B,16], blocks uint8[B,nb,16],
nvalid int32[B]; the chains return uint8[B,nb,16], the MAC uint8[B,16].

Each wrapper dispatches on the device of its data: on CUDA it launches the
hand-written kernel (csrc/chain_packed.cu) or raises, on the CPU it runs the
plain PyTorch version (the packed scans of modes/_scan, which follow the JAX
package's *_scan_packed, and the masked fold of its cbcmac_packed_fused).
There is no fallback from CUDA to the plain versions.
"""
from __future__ import annotations

import torch

from ..core.bitslice import encrypt_planes_multikey, pack_planes, unpack_planes
from ..modes._scan import (
    cbc_encrypt_scan_packed,
    cfb_encrypt_scan_packed,
    ofb_keystream_scan_packed,
    pack_steps,
)
from ..utils.bytesio import i32_from_u32, u32_tensor
from . import _build
from .seal_kernels import _WORD_DTYPES, _device

_KINDS = {"cbc": 0, "cfb": 1, "ofb": 2, "mac": 3}


def chain_keys_from_jax(kpw, *, device="cuda") -> torch.Tensor:
    """The JAX package's lane-packed key planes (numpy uint32[R+1,8,16,W],
    key_planes_packed) as the port's int32 tensor on `device`."""
    return u32_tensor(kpw, device)


def chain_packed_fused_plain(kind: str, kpw, ivs, blocks):
    """Plain PyTorch version of chain_packed_fused (same contract)."""
    kpw = kpw.view(torch.int32)
    if kind == "cbc":
        return cbc_encrypt_scan_packed(kpw, ivs, blocks)
    if kind == "cfb":
        return cfb_encrypt_scan_packed(kpw, ivs, blocks)
    raise ValueError(f"chain_packed_fused: unknown kind {kind!r}")


def ofb_packed_fused_plain(kpw, ivs, nb: int):
    """Plain PyTorch version of ofb_packed_fused (same contract)."""
    return ofb_keystream_scan_packed(kpw.view(torch.int32), ivs, nb)


def _step_masks(nvalid: torch.Tensor, nb: int) -> torch.Tensor:
    """int32[nb, W]: bit j of word w of row t set while step t counts for
    message 32w+j (t < nvalid)."""
    lanes = nvalid.to(torch.int64).reshape(-1, 32)
    steps = torch.arange(nb, dtype=torch.int64, device=nvalid.device)
    bits = (steps[:, None, None] < lanes[None]).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=nvalid.device)
    return i32_from_u32((bits << shifts).sum(dim=-1))


def cbcmac_packed_fused_plain(kpw, init, blocks, nvalid):
    """Plain PyTorch version of cbcmac_packed_fused (same contract)."""
    kpw = kpw.view(torch.int32)
    carry = pack_planes(init)
    masks = _step_masks(nvalid, blocks.shape[1])
    for x, mask in zip(pack_steps(blocks), masks):
        m2 = encrypt_planes_multikey(kpw, carry ^ x)
        carry = carry ^ (mask & (m2 ^ carry))
    return unpack_planes(carry, init.shape[0])


def _check(name, kpw, ivs, blocks=None, nvalid=None):
    """Raise on what the kernel does not take -> (rounds, W)."""
    dev = ivs.device
    if kpw.dim() != 4 or kpw.shape[1:3] != (8, 16) or kpw.shape[0] - 1 not in (10, 12, 14):
        raise ValueError(f"{name}: kpw shape {tuple(kpw.shape)}")
    if kpw.dtype not in _WORD_DTYPES:
        raise TypeError(f"{name}: kpw must be int32 or uint32, got {kpw.dtype}")
    w = kpw.shape[3]
    if ivs.shape != (32 * w, 16):
        raise ValueError(f"{name}: ivs shape {tuple(ivs.shape)} for W={w}")
    if blocks is not None and (blocks.dim() != 3 or blocks.shape[0] != 32 * w
                               or blocks.shape[2] != 16):
        raise ValueError(f"{name}: blocks shape {tuple(blocks.shape)} for W={w}")
    if nvalid is not None:
        if nvalid.shape != (32 * w,):
            raise ValueError(f"{name}: nvalid shape {tuple(nvalid.shape)} for W={w}")
        if nvalid.dtype != torch.int32:
            raise TypeError(f"{name}: nvalid must be int32, got {nvalid.dtype}")
    for arg, t in (("kpw", kpw), ("ivs", ivs), ("blocks", blocks), ("nvalid", nvalid)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {dev}")
        if arg in ("ivs", "blocks") and t.dtype != torch.uint8:
            raise TypeError(f"{name}: {arg} must be uint8, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    return kpw.shape[0] - 1, w


def _launch(name, kind, kpw, ivs, blocks, nvalid, out, rounds, w, nb):
    lib = _build.load()
    dev = ivs.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.micro_aes_chain_packed(
            kpw.data_ptr(), ivs.data_ptr(), None if blocks is None else blocks.data_ptr(),
            None if nvalid is None else nvalid.data_ptr(), out.data_ptr(), _KINDS[kind],
            rounds, w, nb, stream)
    _build.check_launch(name, err)


def chain_packed_fused(kind: str, kpw, ivs, blocks):
    """K13 CBC or CFB (`kind` "cbc" or "cfb"): kpw [R+1,8,16,W], ivs
    uint8[B,16], blocks uint8[B,nb,16], B = 32W -> uint8[B,nb,16]."""
    if _device("chain_packed_fused", blocks).type == "cpu":
        return chain_packed_fused_plain(kind, kpw, ivs, blocks)
    if kind not in ("cbc", "cfb"):
        raise ValueError(f"chain_packed_fused: unknown kind {kind!r}")
    rounds, w = _check("chain_packed_fused", kpw, ivs, blocks)
    out = torch.empty_like(blocks)
    if w and blocks.shape[1]:
        _launch("chain_packed_fused", kind, kpw, ivs, blocks, None, out, rounds, w,
                blocks.shape[1])
        chain_packed_fused.launches += 1
    return out


chain_packed_fused.launches = 0


def ofb_packed_fused(kpw, ivs, nb: int):
    """K13 OFB: kpw [R+1,8,16,W], ivs uint8[B,16], B = 32W -> uint8[B,nb,16]
    of keystream blocks (no data operand)."""
    if _device("ofb_packed_fused", ivs).type == "cpu":
        return ofb_packed_fused_plain(kpw, ivs, nb)
    rounds, w = _check("ofb_packed_fused", kpw, ivs)
    if nb < 0:
        raise ValueError(f"ofb_packed_fused: nb {nb}")
    out = torch.empty((ivs.shape[0], nb, 16), dtype=torch.uint8, device=ivs.device)
    if w and nb:
        _launch("ofb_packed_fused", "ofb", kpw, ivs, None, None, out, rounds, w, nb)
        ofb_packed_fused.launches += 1
    return out


ofb_packed_fused.launches = 0


def cbcmac_packed_fused(kpw, init, blocks, nvalid):
    """K13 masked CBC-MAC: kpw [R+1,8,16,W], init uint8[B,16], blocks
    uint8[B,nb,16], nvalid int32[B], B = 32W -> uint8[B,16]: the fold of
    each message's first nvalid blocks."""
    if _device("cbcmac_packed_fused", blocks).type == "cpu":
        return cbcmac_packed_fused_plain(kpw, init, blocks, nvalid)
    rounds, w = _check("cbcmac_packed_fused", kpw, init, blocks, nvalid)
    out = torch.empty_like(init)
    if w:
        _launch("cbcmac_packed_fused", "mac", kpw, init, blocks, nvalid, out, rounds, w,
                blocks.shape[1])
        cbcmac_packed_fused.launches += 1
    return out


cbcmac_packed_fused.launches = 0
