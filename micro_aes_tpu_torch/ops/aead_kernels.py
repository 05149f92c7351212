"""K11 and K12: the one-pass AEAD chains over B = 32W independent messages,
each under its own key (CCM, EAX and SIV batches, modes/bulk), and K15, the
counter half of K11 alone.

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
      recovered plaintext in one pass -> (pt, s2v).
  ctr_packed_fused(kpw, c0, blocks)
      K15: blocks ^ E_k(c0 + t) for step t of each message (zeros give the
      raw keystream) -> uint8[B,nb,16].  No step needs another.  On no path
      of the port: the JAX package runs it only in its unfused SIV keystream
      (MICRO_AES_SIV_FUSED=0 on a TPU), and the port always fuses SIV into
      K12.

At a message's last valid MAC step its block becomes (x & tail) ^ lastadd
(SIV also XORs prevadd into the step before); steps at or past nvalid leave
the MAC alone, but `out` is written for every step.  Counters count on the
56-bit big-endian window of bytes 9..15 (ops/counter.ctr56_add).  kpw,
kpw_mac and kpw_ctr are int32 (or uint32) [R+1,8,16,W] lane-packed key
planes as for K13 (ops/chain_kernels.chain_keys_from_jax carries the JAX
package's key_planes_packed across); the other operands are uint8 [B,16],
blocks uint8 [B,nb,16] and nvalid int32 [B], the JAX package's shapes.

Each wrapper dispatches on the device of its data: on CUDA it launches the
hand-written kernel (csrc/aead_chain.cu) or raises, on the CPU it runs the
plain PyTorch version (the JAX package's jnp twins: the local bodies of
parallel/batch.aead_sharded_fn and siv_sharded_fn, and for the SIV open,
which has no twin, that body run the other way round; for K15 the keystream
of the byte cipher on ops/counter.ctr56_add's counters).  There is no
fallback from CUDA to the plain versions.
"""
from __future__ import annotations

import torch

from ..core.bitslice import lane_round_keys
from ..core.cipher import encrypt_blocks
from . import _build
from .counter import ctr56_add
from .mac import cbcmac_fold_batch
from .seal_kernels import _WORD_DTYPES, _device

_OPS = {("ccm", False): 0, ("ccm", True): 1, ("eax", False): 2, ("eax", True): 3,
        "siv_seal": 4, "siv_open": 5}


def _keystream(rk, c0, n: int, start: int = 0) -> torch.Tensor:
    """E_k(c0 + start + i) for i < n, a key per message: rk uint8[R+1,B,16],
    c0 uint8[B,16] -> uint8[B,n,16]."""
    steps = torch.arange(start, start + n, dtype=torch.int64, device=c0.device)
    return encrypt_blocks(rk[:, :, None, :], ctr56_add(c0[:, None, :], steps))


def _mac_input(src, nvalid, tail, lastadd, prevadd=None):
    """The MAC blocks: (src & tail) ^ lastadd at each message's last valid
    step, prevadd XORed in at the step before it."""
    idx = torch.arange(src.shape[1], device=src.device)[None, :, None]
    nv = nvalid.to(torch.int64)[:, None, None]
    fin = (src & tail[:, None, :]) ^ lastadd[:, None, :]
    macin = torch.where(idx == nv - 1, fin, src)
    if prevadd is not None:
        macin = macin ^ torch.where(idx == nv - 2, prevadd[:, None, :], 0)
    return macin


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
    mac = _fold(rk, init, _mac_input(macsrc, nvalid, tail, lastadd), nvalid)
    return out, (ks_all[:, 0] ^ mac) if whiten else mac


def siv_seal_chain_fused_plain(kpw_mac, kpw_ctr, init, blocks, nvalid, tail, lastadd,
                               prevadd):
    """Plain PyTorch version of siv_seal_chain_fused (same contract)."""
    iv = _fold(lane_round_keys(kpw_mac), init,
               _mac_input(blocks, nvalid, tail, lastadd, prevadd), nvalid)
    ks = _keystream(lane_round_keys(kpw_ctr), _siv_bases(iv), blocks.shape[1])
    return blocks ^ ks, iv


def siv_open_chain_fused_plain(kpw_mac, kpw_ctr, c0, init, blocks, nvalid, tail, lastadd,
                               prevadd):
    """Plain PyTorch version of siv_open_chain_fused (same contract)."""
    pt = blocks ^ _keystream(lane_round_keys(kpw_ctr), c0, blocks.shape[1])
    s2v = _fold(lane_round_keys(kpw_mac), init,
                _mac_input(pt, nvalid, tail, lastadd, prevadd), nvalid)
    return pt, s2v


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


def _launch(name, op, kpw_mac, kpw_ctr, c0, init, blocks, nvalid, tail, lastadd, prevadd,
            rounds, w):
    out = torch.empty_like(blocks)
    tag = torch.empty_like(init)
    if w:
        lib = _build.load()
        dev = blocks.device

        def ptr(t):
            return None if t is None else t.data_ptr()

        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.micro_aes_aead_chain(
                kpw_mac.data_ptr(), kpw_ctr.data_ptr(), ptr(c0), init.data_ptr(),
                blocks.data_ptr(), nvalid.data_ptr(), tail.data_ptr(), lastadd.data_ptr(),
                ptr(prevadd), out.data_ptr(), tag.data_ptr(), op, rounds, w, blocks.shape[1],
                stream)
        _build.check_launch(name, err)
    return out, tag


def aead_chain_fused(kind: str, kpw, c0, init, blocks, nvalid, tail, lastadd,
                     decrypt: bool = False):
    """K11 (CCM or EAX): kpw [R+1,8,16,W], c0/init/tail/lastadd uint8[B,16],
    blocks uint8[B,nb,16], nvalid int32[B], B = 32W -> (out uint8[B,nb,16],
    tag uint8[B,16])."""
    if kind not in ("ccm", "eax"):
        raise ValueError(f"aead_chain_fused: unknown kind {kind!r}")
    if _device("aead_chain_fused", blocks).type == "cpu":
        return aead_chain_fused_plain(kind, kpw, c0, init, blocks, nvalid, tail, lastadd,
                                      decrypt)
    rows = {"c0": c0, "init": init, "tail": tail, "lastadd": lastadd}
    rounds, w = _check("aead_chain_fused", (kpw,), rows, blocks, nvalid)
    res = _launch("aead_chain_fused", _OPS[kind, bool(decrypt)], kpw, kpw, c0, init, blocks,
                  nvalid, tail, lastadd, None, rounds, w)
    if w:
        aead_chain_fused.launches += 1
    return res


aead_chain_fused.launches = 0


def siv_seal_chain_fused(kpw_mac, kpw_ctr, init, blocks, nvalid, tail, lastadd, prevadd):
    """K12 seal: kpw_mac/kpw_ctr [R+1,8,16,W] (K1 and K2), init/tail/lastadd/
    prevadd uint8[B,16], blocks uint8[B,nb,16] (zero-padded plaintext),
    nvalid int32[B] (MAC blocks, at least 1), B = 32W -> (ct uint8[B,nb,16],
    iv uint8[B,16], the raw S2V value)."""
    if _device("siv_seal_chain_fused", blocks).type == "cpu":
        return siv_seal_chain_fused_plain(kpw_mac, kpw_ctr, init, blocks, nvalid, tail,
                                          lastadd, prevadd)
    rows = {"init": init, "tail": tail, "lastadd": lastadd, "prevadd": prevadd}
    rounds, w = _check("siv_seal_chain_fused", (kpw_mac, kpw_ctr), rows, blocks, nvalid)
    res = _launch("siv_seal_chain_fused", _OPS["siv_seal"], kpw_mac, kpw_ctr, None, init,
                  blocks, nvalid, tail, lastadd, prevadd, rounds, w)
    if w:
        siv_seal_chain_fused.launches += 1
    return res


siv_seal_chain_fused.launches = 0


def siv_open_chain_fused(kpw_mac, kpw_ctr, c0, init, blocks, nvalid, tail, lastadd,
                         prevadd):
    """K12 open: as siv_seal_chain_fused, with c0 uint8[B,16] the received
    IV with bit 7 of bytes 8 and 12 cleared (the counter base) and blocks the
    zero-padded ciphertext -> (pt uint8[B,nb,16], s2v uint8[B,16]); the
    caller compares s2v with the received IV."""
    if _device("siv_open_chain_fused", blocks).type == "cpu":
        return siv_open_chain_fused_plain(kpw_mac, kpw_ctr, c0, init, blocks, nvalid, tail,
                                          lastadd, prevadd)
    rows = {"c0": c0, "init": init, "tail": tail, "lastadd": lastadd, "prevadd": prevadd}
    rounds, w = _check("siv_open_chain_fused", (kpw_mac, kpw_ctr), rows, blocks, nvalid)
    res = _launch("siv_open_chain_fused", _OPS["siv_open"], kpw_mac, kpw_ctr, c0, init,
                  blocks, nvalid, tail, lastadd, prevadd, rounds, w)
    if w:
        siv_open_chain_fused.launches += 1
    return res


siv_open_chain_fused.launches = 0


def ctr_packed_fused_plain(kpw, c0, blocks):
    """Plain PyTorch version of ctr_packed_fused (same contract)."""
    return _keystream(lane_round_keys(kpw), c0, blocks.shape[1]) ^ blocks


def ctr_packed_fused(kpw, c0, blocks):
    """K15: kpw [R+1,8,16,W], c0 uint8[B,16], blocks uint8[B,nb,16], B = 32W
    -> uint8[B,nb,16], block t of message m XORed with E_{k_m}(c0_m + t)."""
    if _device("ctr_packed_fused", blocks).type == "cpu":
        return ctr_packed_fused_plain(kpw, c0, blocks)
    rounds, w = _check("ctr_packed_fused", (kpw,), {"c0": c0}, blocks)
    out = torch.empty_like(blocks)
    if w and blocks.shape[1]:
        lib = _build.load()
        with torch.cuda.device(blocks.device):
            stream = torch.cuda.current_stream(blocks.device).cuda_stream
            err = lib.micro_aes_ctr_packed(kpw.data_ptr(), c0.data_ptr(), blocks.data_ptr(),
                                           out.data_ptr(), rounds, w, blocks.shape[1], stream)
        _build.check_launch("ctr_packed_fused", err)
        ctr_packed_fused.launches += 1
    return out


ctr_packed_fused.launches = 0
