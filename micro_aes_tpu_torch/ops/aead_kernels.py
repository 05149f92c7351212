"""K11 and K12: the one-pass AEAD chains over B = 32W independent messages,
each under its own key (CCM, EAX and SIV batches, modes/bulk), and K15, the
lane-packed CTR keystream they run on.

  aead_chain_fused(kind, kpw, c0, init, blocks, nvalid, tail, lastadd, decrypt)
      K11, CCM ("ccm") or EAX ("eax"): the CTR keystream from each message's
      counter base c0 XORed onto blocks, and the masked CBC-MAC from init
      over the plaintext side (CCM seal and EAX open fold the input, the
      other two the output) -> (out, tag).  CCM runs a leading step that
      makes E(c0) and counts its payload from c0 + 1; its tag is E(c0) ^ MAC.
      EAX counts from c0 and returns the raw MAC.
  siv_seal_chain_fused(kpw_mac, kpw_ctr, init, blocks, nvalid, tail,
                       lastadd, prevadd)
      K12 seal: the S2V fold under the MAC keys, then SIV-CTR under the CTR
      keys from the fold's result with bit 7 of bytes 8 and 12 cleared ->
      (ct, raw iv).
  siv_open_chain_fused(kpw_mac, kpw_ctr, c0, init, blocks, nvalid, tail,
                       lastadd, prevadd)
      K12 open: SIV-CTR from c0 (already cleared) and the S2V fold of the
      recovered plaintext -> (pt, s2v).
  ctr_packed_fused(kpw, c0, blocks, whiten=False)
      K15: blocks ^ E_k(c0 + t) for step t of each message (zeros give the
      raw keystream) -> uint8[B,nb,16]; with whiten (CCM) also E(c0) ->
      (out, wh), the payload counted from c0 + 1.  No step needs another.

At a message's last valid MAC step its block becomes (x & tail) ^ lastadd
(SIV also XORs prevadd into the step before); steps at or past nvalid leave
the MAC alone, but `out` is written for every step.  Counters count on the
56-bit big-endian window of bytes 9..15 (ops/counter.ctr56_add).  kpw,
kpw_mac and kpw_ctr are int32 (or uint32) [R+1,8,16,W] lane-packed key
planes as for K13 (ops/chain_kernels.chain_keys_from_jax carries the JAX
package's key_planes_packed across); the other operands are uint8 [B,16],
blocks uint8 [B,nb,16] and nvalid int32 [B], the JAX package's shapes.

K11 and K12 are two launches each, in the order their data need: the
keystream pass (K15, csrc/aead_chain.cu) and the MAC chain alone (K13's
masked CBC-MAC with the last-step constants, ops/chain_kernels.
cbcmac_packed_fused); only the MAC is serial, so the keystream no longer
rides the chain.  CCM seal and EAX open fold the input, CCM open, EAX seal
and SIV open the keystream pass's output; SIV seal folds first and starts
its keystream from the fold.  CCM's tag is the whitener E(c0) XORed onto the
MAC.  The `launches` of the three composed calls count the K15 and K13
launches each call made, taken from those kernels' own counters where they
launch.  The wrappers dispatch on the device of their
data: on CUDA the kernels launch or raise, on the CPU the same two steps
run the plain PyTorch versions.  The monolithic plain versions
(aead_chain_fused_plain, siv_*_chain_fused_plain: the JAX package's jnp
twins, the local bodies of parallel/batch.aead_sharded_fn and
siv_sharded_fn, and for the SIV open, which has no twin, that body run the
other way round) are the contract's reference.  There is no fallback from
CUDA to the plain versions.
"""
from __future__ import annotations

import torch

from ..core.bitslice import lane_round_keys
from ..core.cipher import encrypt_blocks
from . import _build
from .chain_kernels import cbcmac_packed_fused, mac_input
from .counter import ctr56_add
from .mac import cbcmac_fold_batch
from .seal_kernels import _WORD_DTYPES, _device


def _keystream(rk, c0, n: int, start: int = 0) -> torch.Tensor:
    """E_k(c0 + start + i) for i < n, a key per message: rk uint8[R+1,B,16],
    c0 uint8[B,16] -> uint8[B,n,16]."""
    steps = torch.arange(start, start + n, dtype=torch.int64, device=c0.device)
    return encrypt_blocks(rk[:, :, None, :], ctr56_add(c0[:, None, :], steps))


def _fold(rk, init, macin, nvalid):
    return cbcmac_fold_batch(rk.transpose(0, 1), init, macin, nvalid.cpu())


def _siv_bases(iv: torch.Tensor) -> torch.Tensor:
    """The SIV counter bases: bit 7 of bytes 8 and 12 cleared
    (micro_aes.c:931-934)."""
    bases = iv.clone()
    bases[:, 8] &= 0x7F
    bases[:, 12] &= 0x7F
    return bases


def aead_chain_fused_plain(kind: str, kpw, c0, init, blocks, nvalid, tail, lastadd,
                           decrypt: bool = False):
    """Plain PyTorch version of aead_chain_fused (same contract)."""
    rk = lane_round_keys(kpw)
    whiten = kind == "ccm"
    ks_all = _keystream(rk, c0, blocks.shape[1] + whiten)
    ks = ks_all[:, 1:] if whiten else ks_all
    out = blocks ^ ks
    macsrc = blocks if (kind == "ccm") != bool(decrypt) else out
    mac = _fold(rk, init, mac_input(macsrc, nvalid, tail, lastadd), nvalid)
    return out, (ks_all[:, 0] ^ mac) if whiten else mac


def siv_seal_chain_fused_plain(kpw_mac, kpw_ctr, init, blocks, nvalid, tail, lastadd,
                               prevadd):
    """Plain PyTorch version of siv_seal_chain_fused (same contract)."""
    iv = _fold(lane_round_keys(kpw_mac), init,
               mac_input(blocks, nvalid, tail, lastadd, prevadd), nvalid)
    ks = _keystream(lane_round_keys(kpw_ctr), _siv_bases(iv), blocks.shape[1])
    return blocks ^ ks, iv


def siv_open_chain_fused_plain(kpw_mac, kpw_ctr, c0, init, blocks, nvalid, tail, lastadd,
                               prevadd):
    """Plain PyTorch version of siv_open_chain_fused (same contract)."""
    pt = blocks ^ _keystream(lane_round_keys(kpw_ctr), c0, blocks.shape[1])
    s2v = _fold(lane_round_keys(kpw_mac), init,
                mac_input(pt, nvalid, tail, lastadd, prevadd), nvalid)
    return pt, s2v


def _launched() -> int:
    """The K15 and K13 MAC launches so far, each counted where it launches."""
    return ctr_packed_fused.launches + cbcmac_packed_fused.launches


def _check(name, kpws, rows: dict, blocks, nvalid=None):
    """Raise on what the kernel does not take -> (rounds, W)."""
    dev = blocks.device
    for kpw in kpws:
        if (kpw.dim() != 4 or kpw.shape[1:3] != (8, 16)
                or kpw.shape[0] - 1 not in (10, 12, 14)):
            raise ValueError(f"{name}: kpw shape {tuple(kpw.shape)}")
        if kpw.dtype not in _WORD_DTYPES:
            raise TypeError(f"{name}: kpw must be int32 or uint32, got {kpw.dtype}")
        if kpw.shape != kpws[0].shape:
            raise ValueError(f"{name}: MAC and CTR key planes differ in shape")
    w = kpws[0].shape[3]
    b = 32 * w
    if blocks.dim() != 3 or blocks.shape[0] != b or blocks.shape[2] != 16:
        raise ValueError(f"{name}: blocks shape {tuple(blocks.shape)} for W={w}")
    if nvalid is not None and nvalid.shape != (b,):
        raise ValueError(f"{name}: nvalid shape {tuple(nvalid.shape)} for W={w}")
    if nvalid is not None and nvalid.dtype != torch.int32:
        raise TypeError(f"{name}: nvalid must be int32, got {nvalid.dtype}")
    for arg, t in {**rows, "blocks": blocks}.items():
        if arg != "blocks" and t.shape != (b, 16):
            raise ValueError(f"{name}: {arg} shape {tuple(t.shape)} for W={w}")
        if t.dtype != torch.uint8:
            raise TypeError(f"{name}: {arg} must be uint8, got {t.dtype}")
    named = {**{f"kpw{i}": k for i, k in enumerate(kpws)}, **rows, "blocks": blocks,
             "nvalid": nvalid}
    for arg, t in named.items():
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    return kpws[0].shape[0] - 1, w


def aead_chain_fused(kind: str, kpw, c0, init, blocks, nvalid, tail, lastadd,
                     decrypt: bool = False):
    """K11 (CCM or EAX): kpw [R+1,8,16,W], c0/init/tail/lastadd uint8[B,16],
    blocks uint8[B,nb,16], nvalid int32[B], B = 32W -> (out uint8[B,nb,16],
    tag uint8[B,16]): the keystream pass, then the MAC."""
    if kind not in ("ccm", "eax"):
        raise ValueError(f"aead_chain_fused: unknown kind {kind!r}")
    _device("aead_chain_fused", blocks)
    rows = {"c0": c0, "init": init, "tail": tail, "lastadd": lastadd}
    _check("aead_chain_fused", (kpw,), rows, blocks, nvalid)
    before = _launched()
    if kind == "ccm":
        out, wh = ctr_packed_fused(kpw, c0, blocks, whiten=True)
    else:
        out, wh = ctr_packed_fused(kpw, c0, blocks), None
    src = blocks if (kind == "ccm") != bool(decrypt) else out
    tag = cbcmac_packed_fused(kpw, init, src, nvalid, tail, lastadd)
    aead_chain_fused.launches += _launched() - before
    return out, tag if wh is None else tag ^ wh


aead_chain_fused.launches = 0


def siv_seal_chain_fused(kpw_mac, kpw_ctr, init, blocks, nvalid, tail, lastadd, prevadd):
    """K12 seal: kpw_mac/kpw_ctr [R+1,8,16,W] (K1 and K2), init/tail/lastadd/
    prevadd uint8[B,16], blocks uint8[B,nb,16] (zero-padded plaintext),
    nvalid int32[B] (MAC blocks, at least 1), B = 32W -> (ct uint8[B,nb,16],
    iv uint8[B,16], the raw S2V value): the S2V fold, then the keystream
    pass from it."""
    _device("siv_seal_chain_fused", blocks)
    rows = {"init": init, "tail": tail, "lastadd": lastadd, "prevadd": prevadd}
    _check("siv_seal_chain_fused", (kpw_mac, kpw_ctr), rows, blocks, nvalid)
    before = _launched()
    iv = cbcmac_packed_fused(kpw_mac, init, blocks, nvalid, tail, lastadd, prevadd)
    ct = ctr_packed_fused(kpw_ctr, _siv_bases(iv), blocks)
    siv_seal_chain_fused.launches += _launched() - before
    return ct, iv


siv_seal_chain_fused.launches = 0


def siv_open_chain_fused(kpw_mac, kpw_ctr, c0, init, blocks, nvalid, tail, lastadd,
                         prevadd):
    """K12 open: as siv_seal_chain_fused, with c0 uint8[B,16] the received
    IV with bit 7 of bytes 8 and 12 cleared (the counter base) and blocks the
    zero-padded ciphertext -> (pt uint8[B,nb,16], s2v uint8[B,16]): the
    keystream pass, then the S2V fold of its output; the caller compares
    s2v with the received IV."""
    _device("siv_open_chain_fused", blocks)
    rows = {"c0": c0, "init": init, "tail": tail, "lastadd": lastadd, "prevadd": prevadd}
    _check("siv_open_chain_fused", (kpw_mac, kpw_ctr), rows, blocks, nvalid)
    before = _launched()
    pt = ctr_packed_fused(kpw_ctr, c0, blocks)
    s2v = cbcmac_packed_fused(kpw_mac, init, pt, nvalid, tail, lastadd, prevadd)
    siv_open_chain_fused.launches += _launched() - before
    return pt, s2v


siv_open_chain_fused.launches = 0


def ctr_packed_fused_plain(kpw, c0, blocks, whiten: bool = False):
    """Plain PyTorch version of ctr_packed_fused (same contract)."""
    ks = _keystream(lane_round_keys(kpw), c0, blocks.shape[1] + whiten)
    if whiten:
        return blocks ^ ks[:, 1:], ks[:, 0].contiguous()
    return blocks ^ ks


def ctr_packed_fused(kpw, c0, blocks, whiten: bool = False):
    """K15: kpw [R+1,8,16,W], c0 uint8[B,16], blocks uint8[B,nb,16], B = 32W
    -> uint8[B,nb,16], block t of message m XORed with E_{k_m}(c0_m + t);
    with whiten -> (that from c0 + 1 + t, wh = E(c0) uint8[B,16]).  On CUDA
    c0 and blocks must be 16-byte aligned (the kernel moves 16-byte words)."""
    if _device("ctr_packed_fused", blocks).type == "cpu":
        return ctr_packed_fused_plain(kpw, c0, blocks, whiten)
    rounds, w = _check("ctr_packed_fused", (kpw,), {"c0": c0}, blocks)
    if c0.data_ptr() % 16 or blocks.data_ptr() % 16:
        raise ValueError("ctr_packed_fused: c0 and blocks must be 16-byte aligned")
    out = torch.empty_like(blocks)
    wh = torch.empty_like(c0) if whiten else None
    if w and (blocks.shape[1] or whiten):
        lib = _build.load()
        with torch.cuda.device(blocks.device):
            stream = torch.cuda.current_stream(blocks.device).cuda_stream
            err = lib.micro_aes_ctr_packed(kpw.data_ptr(), c0.data_ptr(), blocks.data_ptr(),
                                           out.data_ptr(), None if wh is None else wh.data_ptr(),
                                           rounds, w, blocks.shape[1], 0, stream)
        _build.check_launch("ctr_packed_fused", err)
        ctr_packed_fused.launches += 1
    return (out, wh) if whiten else out


ctr_packed_fused.launches = 0
