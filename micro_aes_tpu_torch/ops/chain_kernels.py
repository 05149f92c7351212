"""K13 and K14: the lane-packed serial chains over B = 32W independent
messages, each under its own key, 32 messages per int32 plane word.

  chain_packed_fused("cbc", kpw, ivs, blocks)  y_t = E(y_{t-1} ^ x_t)
  chain_packed_fused("cfb", kpw, ivs, blocks)  y_t = E(y_{t-1}) ^ x_t
  ofb_packed_fused(kpw, ivs, nb)               y_t = E(y_{t-1})
  cbcmac_packed_fused(kpw, init, blocks, nvalid, tail=None, lastadd=None,
                      prevadd=None)
                                               m = E(m ^ x_t) while t < nvalid
                                               of the message; returns m

with y_{-1} = the message's iv (or init).  The MAC optionally takes the
one-pass AEAD chains' last-step constants (K11/K12 run their MAC on it,
ops/aead_kernels): at a message's last valid step its block becomes
(x & tail) ^ lastadd, and at the step before it x ^ prevadd; each is
uint8[B,16] or None (tail and lastadd together).
kpw int32 (or uint32)
[R+1,8,16,W] lane-packed key planes (bit j of word w = message 32w+j,
core/bitslice.key_planes_packed), ivs/init uint8[B,16], blocks uint8[B,nb,16],
nvalid int32[B]; the chains return uint8[B,nb,16], the MAC uint8[B,16].

K14 is K13's CBC/CFB and OFB in the wide message map (core/bitslice):

  chain_packed_fused_wide(kind, kpw_w, ivs, blocks)
  ofb_packed_fused_wide(kpw_w, ivs, nb)

with kpw_w packed from rks[wide_perm(B)] and B satisfying wide_ok(B); ivs,
blocks and the result stay in natural message order.  It is on no path of
the port (nor of the JAX package).

The ragged entry runs CBC, CFB or OFB over a whole batch of messages of
different lengths and key sizes in one launch, in ops/ragged's layout:

  chain_packed_ragged(kind, kpw15, desc, ivs, blocks=None, nbytes=None)

kpw15 int32[15,8,16,W] the words' key planes padded to 15 round keys
(ragged_key_planes), desc int64[W,4] the words' (steps, rounds | live << 8,
msg0, off), ivs uint8[M,16] in packed order, blocks uint8[N] the messages'
blocks packed as rows (CBC, CFB; OFB takes the buffer size nbytes instead)
-> uint8[N], each message's row of outputs where its blocks lie.  The
uniform wrappers launch the same kernel with the descriptor of every word
computed from (nb, rounds, tile).

Each wrapper dispatches on the device of its data: on CUDA it launches the
hand-written kernel (csrc/chain_packed.cu) or raises, on the CPU it runs the
plain PyTorch version (the packed scans of modes/_scan, which follow the JAX
package's *_scan_packed, and the masked fold of its cbcmac_packed_fused; K14's
gather the messages into slot order, run K13's and scatter the result back).
There is no fallback from CUDA to the plain versions.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.bitslice import (
    encrypt_planes_multikey,
    pack_planes,
    require_wide,
    unpack_planes,
    wide_perm,
    wide_tile,
)
from ..modes._scan import (
    cbc_encrypt_scan_packed,
    cfb_encrypt_scan_packed,
    ofb_keystream_scan_packed,
    pack_steps,
)
from ..utils.bytesio import i32_from_u32, u32_tensor
from . import _build
from .ragged import aligned, check_desc, desc_array
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


def mac_input(src, nvalid, tail, lastadd, prevadd=None):
    """The MAC blocks with the last-step constants applied: (src & tail) ^
    lastadd at each message's last valid step, prevadd XORed in at the step
    before it."""
    idx = torch.arange(src.shape[1], device=src.device)[None, :, None]
    nv = nvalid.to(torch.int64)[:, None, None]
    last = (src & tail[:, None, :]) ^ lastadd[:, None, :]
    macin = torch.where(idx == nv - 1, last, src)
    if prevadd is not None:
        macin = macin ^ torch.where(idx == nv - 2, prevadd[:, None, :], 0)
    return macin


def cbcmac_packed_fused_plain(kpw, init, blocks, nvalid, tail=None, lastadd=None, prevadd=None):
    """Plain PyTorch version of cbcmac_packed_fused (same contract)."""
    kpw = kpw.view(torch.int32)
    if tail is not None:
        blocks = mac_input(blocks, nvalid, tail, lastadd, prevadd)
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


def _launch(name, kind, kpw, ivs, blocks, nvalid, out, rounds, w, nb, tile=1, consts=()):
    """One uniform launch; consts = the MAC's (tail, lastadd, prevadd),
    each a tensor or None."""
    ivs, blocks = aligned(ivs, 16), aligned(blocks, 16)
    tail, lastadd, prevadd = (aligned(t, 16) for t in (tuple(consts) or (None,) * 3))
    lib = _build.load()
    dev = ivs.device

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.micro_aes_chain_packed(
            kpw.data_ptr(), ivs.data_ptr(), ptr(blocks), ptr(nvalid), ptr(tail), ptr(lastadd),
            ptr(prevadd), out.data_ptr(), _KINDS[kind], rounds, w, nb, tile, stream)
    _build.check_launch(name, err)


def _chain(name, kind, kpw, ivs, blocks, tile) -> tuple[torch.Tensor, bool]:
    """Launch K13/K14's CBC or CFB in the map of `tile` -> (out, launched)."""
    if kind not in ("cbc", "cfb"):
        raise ValueError(f"{name}: unknown kind {kind!r}")
    rounds, w = _check(name, kpw, ivs, blocks)
    out = torch.empty_like(blocks)
    launched = bool(w and blocks.shape[1])
    if launched:
        _launch(name, kind, kpw, ivs, blocks, None, out, rounds, w, blocks.shape[1], tile)
    return out, launched


def _ofb(name, kpw, ivs, nb: int, tile) -> tuple[torch.Tensor, bool]:
    """Launch K13/K14's OFB in the map of `tile` -> (out, launched)."""
    rounds, w = _check(name, kpw, ivs)
    if nb < 0:
        raise ValueError(f"{name}: nb {nb}")
    out = torch.empty((ivs.shape[0], nb, 16), dtype=torch.uint8, device=ivs.device)
    launched = bool(w and nb)
    if launched:
        _launch(name, "ofb", kpw, ivs, None, None, out, rounds, w, nb, tile)
    return out, launched


def chain_packed_fused(kind: str, kpw, ivs, blocks):
    """K13 CBC or CFB (`kind` "cbc" or "cfb"): kpw [R+1,8,16,W], ivs
    uint8[B,16], blocks uint8[B,nb,16], B = 32W -> uint8[B,nb,16]."""
    if _device("chain_packed_fused", blocks).type == "cpu":
        return chain_packed_fused_plain(kind, kpw, ivs, blocks)
    out, launched = _chain("chain_packed_fused", kind, kpw, ivs, blocks, 1)
    chain_packed_fused.launches += launched
    return out


chain_packed_fused.launches = 0


def ofb_packed_fused(kpw, ivs, nb: int):
    """K13 OFB: kpw [R+1,8,16,W], ivs uint8[B,16], B = 32W -> uint8[B,nb,16]
    of keystream blocks (no data operand)."""
    if _device("ofb_packed_fused", ivs).type == "cpu":
        return ofb_packed_fused_plain(kpw, ivs, nb)
    out, launched = _ofb("ofb_packed_fused", kpw, ivs, nb, 1)
    ofb_packed_fused.launches += launched
    return out


ofb_packed_fused.launches = 0


def cbcmac_packed_fused(kpw, init, blocks, nvalid, tail=None, lastadd=None, prevadd=None):
    """K13 masked CBC-MAC: kpw [R+1,8,16,W], init uint8[B,16], blocks
    uint8[B,nb,16], nvalid int32[B], B = 32W -> uint8[B,16]: the fold of
    each message's first nvalid blocks, with the last-step constants tail,
    lastadd (together) and prevadd (uint8[B,16] each) where given."""
    if (tail is None) != (lastadd is None) or (prevadd is not None and tail is None):
        raise ValueError("cbcmac_packed_fused: tail and lastadd go together, prevadd with them")
    consts = (tail, lastadd, prevadd)
    for arg, t in zip(("tail", "lastadd", "prevadd"), consts):
        if t is not None and (t.shape != init.shape or t.dtype != torch.uint8
                              or t.device != init.device or not t.is_contiguous()):
            raise ValueError(f"cbcmac_packed_fused: {arg} {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected contiguous uint8{tuple(init.shape)}")
    if _device("cbcmac_packed_fused", blocks).type == "cpu":
        return cbcmac_packed_fused_plain(kpw, init, blocks, nvalid, *consts)
    rounds, w = _check("cbcmac_packed_fused", kpw, init, blocks, nvalid)
    out = torch.empty_like(init)
    if w:
        _launch("cbcmac_packed_fused", "mac", kpw, init, blocks, nvalid, out, rounds, w,
                blocks.shape[1], consts=consts)
        cbcmac_packed_fused.launches += 1
    return out


cbcmac_packed_fused.launches = 0


# -- K14: the same chains in the wide message map ---------------------------

def _slots(name, b: int, device) -> torch.Tensor:
    """wide_perm(B) on `device`; ValueError unless wide_ok(B)."""
    require_wide(name, b)
    return torch.as_tensor(wide_perm(b), device=device)


def chain_packed_fused_wide_plain(kind: str, kpw_w, ivs, blocks):
    """Plain PyTorch version of chain_packed_fused_wide (same contract)."""
    perm = _slots("chain_packed_fused_wide", blocks.shape[0], blocks.device)
    out = torch.empty_like(blocks)
    out[perm] = chain_packed_fused_plain(kind, kpw_w, ivs[perm], blocks[perm])
    return out


def ofb_packed_fused_wide_plain(kpw_w, ivs, nb: int):
    """Plain PyTorch version of ofb_packed_fused_wide (same contract)."""
    perm = _slots("ofb_packed_fused_wide", ivs.shape[0], ivs.device)
    ks = ofb_packed_fused_plain(kpw_w, ivs[perm], nb)
    out = torch.empty_like(ks)
    out[perm] = ks
    return out


def chain_packed_fused_wide(kind: str, kpw_w, ivs, blocks):
    """K14 CBC or CFB: as chain_packed_fused, with kpw_w packed from
    rks[wide_perm(B)] and B satisfying wide_ok(B) (ValueError otherwise)."""
    if _device("chain_packed_fused_wide", blocks).type == "cpu":
        return chain_packed_fused_wide_plain(kind, kpw_w, ivs, blocks)
    require_wide("chain_packed_fused_wide", blocks.shape[0])
    out, launched = _chain("chain_packed_fused_wide", kind, kpw_w, ivs, blocks,
                           wide_tile(blocks.shape[0] // 32))
    chain_packed_fused_wide.launches += launched
    return out


chain_packed_fused_wide.launches = 0


def ofb_packed_fused_wide(kpw_w, ivs, nb: int):
    """K14 OFB: as ofb_packed_fused, with kpw_w packed from rks[wide_perm(B)]
    and B satisfying wide_ok(B) (ValueError otherwise)."""
    if _device("ofb_packed_fused_wide", ivs).type == "cpu":
        return ofb_packed_fused_wide_plain(kpw_w, ivs, nb)
    require_wide("ofb_packed_fused_wide", ivs.shape[0])
    out, launched = _ofb("ofb_packed_fused_wide", kpw_w, ivs, nb, wide_tile(ivs.shape[0] // 32))
    ofb_packed_fused_wide.launches += launched
    return out


ofb_packed_fused_wide.launches = 0


# -- the ragged batch: one launch over words of different lengths and keys ---

def chain_packed_ragged_plain(kind: str, kpw15, desc, ivs, blocks=None, nbytes=None):
    """Plain PyTorch version of chain_packed_ragged (same contract): each key
    size's words through one run of K13's plain version, every slot's blocks
    zero-padded to the longest (a chain's first t outputs do not depend on
    later blocks), the live slots' outputs kept."""
    d = desc_array(desc)
    dev = ivs.device
    out = torch.zeros(blocks.numel() if blocks is not None else nbytes, dtype=torch.uint8,
                      device=dev)
    live = d[:, 1] >> 8
    j = np.arange(32)
    for rounds in sorted({int(x) for x in d[live > 0, 1] & 0xFF}):
        words = np.flatnonzero(((d[:, 1] & 0xFF) == rounds) & (live > 0))
        on = (j[None, :] < live[words, None]).reshape(-1)  # [32Wg]
        nb = np.repeat(d[words, 0], 32)
        jj = np.tile(j, len(words))
        msg = np.where(on, np.repeat(d[words, 2], 32) + jj, 0)
        base = np.repeat(d[words, 3], 32) + jj * 16 * nb
        span = np.arange(16 * int(nb.max()))
        inside = on[:, None] & (span[None, :] < 16 * nb[:, None])
        idx = torch.from_numpy(np.where(inside, base[:, None] + span[None, :], 0)).to(dev)
        inside_t = torch.from_numpy(inside).to(dev)
        kp = kpw15[:rounds + 1, :, :, torch.from_numpy(words).to(kpw15.device)].contiguous()
        iv = ivs[torch.from_numpy(msg).to(dev)] * torch.from_numpy(on).to(dev)[:, None]
        if kind == "ofb":
            y = ofb_packed_fused_plain(kp, iv, int(nb.max()))
        else:
            y = chain_packed_fused_plain(kind, kp, iv, (blocks[idx] * inside_t).reshape(
                len(nb), -1, 16))
        out[idx[inside_t]] = y.reshape(len(nb), -1)[inside_t]
    return out


def chain_packed_ragged(kind: str, kpw15, desc, ivs, blocks=None, nbytes=None):
    """K13 CBC, CFB or OFB over a whole ragged batch in one launch (module
    docstring): kpw15 int32[15,8,16,W], desc int64[W,4] (host array or
    tensor), ivs uint8[M,16], blocks uint8[N] (CBC, CFB) or nbytes (OFB) ->
    uint8[N]."""
    if kind not in ("cbc", "cfb", "ofb"):
        raise ValueError(f"chain_packed_ragged: unknown kind {kind!r}")
    if (blocks is None) != (kind == "ofb"):
        raise ValueError("chain_packed_ragged: CBC and CFB take blocks, OFB nbytes")
    d = desc_array(desc)
    size = blocks.numel() if blocks is not None else int(nbytes)
    if blocks is not None and (blocks.dim() != 1 or blocks.dtype != torch.uint8):
        raise ValueError(f"chain_packed_ragged: blocks must be flat uint8, got {blocks.dtype} "
                         f"{tuple(blocks.shape)}")
    if ivs.dim() != 2 or ivs.shape[1] != 16 or ivs.dtype != torch.uint8:
        raise ValueError(f"chain_packed_ragged: ivs {ivs.dtype} {tuple(ivs.shape)}")
    if kpw15.shape != (15, 8, 16, d.shape[0]) or kpw15.dtype not in _WORD_DTYPES:
        raise ValueError(f"chain_packed_ragged: kpw15 {kpw15.dtype} {tuple(kpw15.shape)} for "
                         f"{d.shape[0]} words")
    check_desc("chain_packed_ragged", d, ivs.shape[0], size, lambda nb: 16 * nb)
    if _device("chain_packed_ragged", ivs).type == "cpu":
        return chain_packed_ragged_plain(kind, kpw15, d, ivs, blocks, nbytes)
    for arg, t in (("kpw15", kpw15), ("ivs", ivs), ("blocks", blocks)):
        if t is not None and (t.device != ivs.device or not t.is_contiguous()):
            raise ValueError(f"chain_packed_ragged: {arg} must be contiguous on {ivs.device}")
    out = torch.empty(size, dtype=torch.uint8, device=ivs.device)
    if d.shape[0]:
        ivs, blocks = aligned(ivs, 16), aligned(blocks, 16)
        desc_t = torch.from_numpy(d).to(ivs.device)
        lib = _build.load()
        with torch.cuda.device(ivs.device):
            stream = torch.cuda.current_stream(ivs.device).cuda_stream
            err = lib.micro_aes_chain_ragged(
                kpw15.data_ptr(), desc_t.data_ptr(), ivs.data_ptr(),
                None if blocks is None else blocks.data_ptr(), out.data_ptr(), _KINDS[kind],
                d.shape[0], stream)
        _build.check_launch("chain_packed_ragged", err)
        chain_packed_ragged.launches += 1
    return out


chain_packed_ragged.launches = 0
