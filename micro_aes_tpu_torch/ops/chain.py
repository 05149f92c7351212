"""K10: the lane-packed multi-key GCM chain, the value-chain engine's kernel.

Each of B lanes (one message, or one segment of one) runs its own GCM chain
over nb steps:

    ctr_t = c0 + t (56-bit big-endian window, ops/counter.ctr56_add)
    out_t = x_t ^ E_k(ctr_t)                 (per-lane key)
    G     = (G ^ src_t) * H                   (per-lane H; src = out when
                                               sealing, x when opening)

with four per-step lane bitmasks [nb, B/32] (bit j of word w = lane 32w+j):
`masks` freezes the carry where clear (no multiply), `srcm` zeroes the
fold source while the multiply still runs, `lastm` selects the step whose
source is masked by `tail`, and `initm` XORs `initadd` into the source at
one step (the JAX kernel's docstring, pallas_chain.py:1274-1284).  The
product G * H is XOR_i bit_i(G) * halve^i(H) over the per-lane halving
table `htab` (ghash_halving_table).

`gcm_chain_fused_raw` dispatches on the device of `blocks`: on CUDA it
launches the hand-written kernel (csrc/gcm_chain.cu) or raises; on the CPU
it runs `gcm_chain_fused_plain`, the plain PyTorch version.  The kernel
reads only H (the table's i = 0 rows) and regenerates the halvings in
registers; the plain version reads the whole table, as the JAX kernel does.
"""
from __future__ import annotations

import torch

from ..core.bitslice import encrypt_planes_multikey, pack_planes, unpack_planes
from ..utils.bytesio import i32_from_u32
from . import _build
from .counter import ctr56_add
from .gf128 import blocks_to_bits
from .mac import halving_table, masked_xor

_U8_ARGS = ("c0", "init", "tail", "initadd", "blocks")
_WORD_ARGS = ("kpw", "htab", "masks", "lastm", "srcm", "initm")


def ghash_halving_table(h_blocks: torch.Tensor) -> torch.Tensor:
    """Per-lane halving table: h_blocks uint8[B,16] (H of each lane, B a
    multiple of 32) -> int32[16384, B/32], row (i*4 + k)*32 + j, column w
    = little-endian word k of halve_be^i(H) of lane 32w+j.  2 KB per lane."""
    b = h_blocks.shape[0]
    w = b // 32
    words = halving_table(h_blocks).reshape(128, w, 32, 4, 4).contiguous().view(torch.int32)
    return words.reshape(128, w, 32, 4).permute(0, 3, 2, 1).reshape(128 * 4 * 32, w).contiguous()


def lane_bits(mask_words: torch.Tensor) -> torch.Tensor:
    """int32[nb, B/32] lane bitmasks -> bool[nb, B] (lane 32w+j = bit j of
    word w)."""
    lanes = torch.arange(32, dtype=torch.int32, device=mask_words.device)
    nb = mask_words.shape[0]
    return ((mask_words.view(torch.int32)[:, :, None] >> lanes) & 1).reshape(nb, -1).bool()


def gcm_chain_fused_plain(kpw, htab, c0, init, blocks, masks, lastm, srcm,
                          initm, tail, initadd, decrypt: bool = False):
    """Plain PyTorch version of gcm_chain_fused_raw (same contract): a loop
    over the nb steps, vectorized over the lanes."""
    b, nb = blocks.shape[0], blocks.shape[1]
    w = b // 32
    kpw = kpw.view(torch.int32)
    # row (i*4+k)*32 + j, column w -> lane 32w+j, halving i, word k
    tab = (htab.view(torch.int32).reshape(128, 4, 32, w).permute(0, 3, 2, 1)
           .reshape(128, b, 4).contiguous().view(torch.uint8))
    valid, last, src_ok, inject = (lane_bits(m) for m in (masks, lastm, srcm, initm))
    out = torch.empty_like(blocks)
    g = init
    for t in range(nb):
        ks = unpack_planes(encrypt_planes_multikey(kpw, pack_planes(ctr56_add(c0, t))), b)
        x = blocks[:, t]
        out[:, t] = x ^ ks
        src = x if decrypt else out[:, t]
        src = torch.where(last[t][:, None], src & tail, src)
        src = torch.where(src_ok[t][:, None], src, 0) ^ torch.where(inject[t][:, None], initadd, 0)
        prod = masked_xor(blocks_to_bits(g ^ src).T.bool(), tab)
        g = torch.where(valid[t][:, None], prod, g)
    return out, g


def _check(name, kpw, htab, c0, init, blocks, masks, lastm, srcm, initm, tail, initadd):
    args = dict(kpw=kpw, htab=htab, c0=c0, init=init, blocks=blocks, masks=masks,
                lastm=lastm, srcm=srcm, initm=initm, tail=tail, initadd=initadd)
    dev = blocks.device
    b, nb = blocks.shape[0], blocks.shape[1]
    w = b // 32
    for arg, t in args.items():
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        want = (torch.uint8,) if arg in _U8_ARGS else (torch.int32, torch.uint32)
        if t.dtype not in want:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}")
        if t.data_ptr() % 16 and arg in _U8_ARGS:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    if b % 32 or blocks.shape != (b, nb, 16):
        raise ValueError(f"{name}: blocks shape {tuple(blocks.shape)} (B a multiple of 32)")
    if kpw.dim() != 4 or kpw.shape[1:] != (8, 16, w) or kpw.shape[0] not in (11, 13, 15):
        raise ValueError(f"{name}: kpw shape {tuple(kpw.shape)}")
    if htab.shape != (16384, w):
        raise ValueError(f"{name}: htab shape {tuple(htab.shape)}")
    for arg in ("c0", "init", "tail", "initadd"):
        if args[arg].shape != (b, 16):
            raise ValueError(f"{name}: {arg} shape {tuple(args[arg].shape)}")
    for arg in ("masks", "lastm", "srcm", "initm"):
        if args[arg].shape != (nb, w):
            raise ValueError(f"{name}: {arg} shape {tuple(args[arg].shape)}")


def gcm_chain_fused_raw(kpw, htab, c0, init, blocks, masks, lastm, srcm,
                        initm, tail, initadd, decrypt: bool = False):
    """kpw int32[R+1,8,16,B/32] (core/bitslice.key_planes_packed), htab
    int32[16384,B/32] (ghash_halving_table), c0/init/tail/initadd
    uint8[B,16] (counter base, initial carry, last-step source mask,
    injected block), blocks uint8[B,nb,16], masks/lastm/srcm/initm
    int32[nb,B/32] -> (out uint8[B,nb,16], g uint8[B,16]).  B % 32 == 0.
    g is the GHASH carry after the last step (no length block folded)."""
    dev = blocks.device
    if dev.type == "cpu":
        return gcm_chain_fused_plain(kpw, htab, c0, init, blocks, masks, lastm,
                                     srcm, initm, tail, initadd, decrypt)
    if dev.type != "cuda":
        raise ValueError(f"gcm_chain_fused_raw: no kernel for device {dev}")
    _check("gcm_chain_fused_raw", kpw, htab, c0, init, blocks, masks, lastm,
           srcm, initm, tail, initadd)
    b, nb = blocks.shape[0], blocks.shape[1]
    out = torch.empty_like(blocks)
    g = torch.empty_like(init)
    if b == 0:
        return out, g
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.micro_aes_gcm_chain(
            kpw.data_ptr(), htab.data_ptr(), c0.data_ptr(), init.data_ptr(),
            blocks.data_ptr(), masks.data_ptr(), lastm.data_ptr(), srcm.data_ptr(),
            initm.data_ptr(), tail.data_ptr(), initadd.data_ptr(), out.data_ptr(),
            g.data_ptr(), kpw.shape[0] - 1, b, nb, int(decrypt), stream)
    _build.check_launch("gcm_chain_fused_raw", err)
    gcm_chain_fused_raw.launches += 1
    return out, g


gcm_chain_fused_raw.launches = 0


def gcm_chain_fused(kpw, htab, c0, init, blocks, nvalid, tail,
                    decrypt: bool = False):
    """Natural-aligned form: message i's nvalid[i] blocks sit at steps
    0..nvalid[i]-1 of lane i; init is the GHASH of its AAD and tail the
    byte mask of its last block.  Builds the step masks (the carry freezes
    after the last block, which `tail` masks) and calls
    gcm_chain_fused_raw.  nvalid int[B] on blocks' device."""
    b, nb = blocks.shape[0], blocks.shape[1]
    steps = torch.arange(nb, device=blocks.device)[:, None]
    nvalid = nvalid.to(torch.int64)[None, :]
    masks = pack_lane_bits(steps < nvalid)
    lastm = pack_lane_bits(steps == nvalid - 1)
    zero_m = torch.zeros_like(masks)
    return gcm_chain_fused_raw(kpw, htab, c0, init, blocks, masks, lastm, masks,
                               zero_m, tail, torch.zeros_like(init), decrypt)


def pack_lane_bits(valid: torch.Tensor) -> torch.Tensor:
    """bool[nb, B] -> int32[nb, B/32] lane bitmasks (inverse of lane_bits)."""
    nb, b = valid.shape
    lanes = torch.arange(32, dtype=torch.int64, device=valid.device)
    return i32_from_u32((valid.reshape(nb, b // 32, 32).to(torch.int64) << lanes).sum(-1))
