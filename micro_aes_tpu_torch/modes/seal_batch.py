"""Multi-key batch AES-GCM: B messages under B keys (a key per connection
or tenant), the value-chain engine.

Fast path (one key size, 12-byte nonces, whole-block messages): one K10
launch (ops/chain.gcm_chain_fused_raw) runs every message's GCM chain,
counter cipher and GHASH fold together, one lane per chain.  The chain is
serial within a message, so a message of nb blocks is split into S
segments of L blocks that run as independent lanes; each message sits
right-aligned in its S*L span (leading zero blocks fold for free: a zero
source into a zero carry), and the segment folds are combined with powers
of H^L:

    G = XOR_s  G_s * H^(L*(S-1-s))

The AAD fold enters as an injection into the fold source at the message's
first data position (equal to starting its chain from that value there),
so every segment has the same exponents.  Then the length block:
G = (G ^ len) * H, tag = E(J0) ^ G (micro_aes.c:1176-1178).

Any other batch (mixed key sizes, other nonce lengths, partial blocks)
goes to the ragged engine, modes/bulk.gcm_encrypt_batch (K9).  Open
verifies each tag before it releases that message (micro_aes.c:1204-1209);
a failed message comes back as None.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.bitslice import key_planes_packed
from ..core.keyschedule import expand_keys_batch
from ..ops.chain import gcm_chain_fused_raw, ghash_halving_table, pack_lane_bits
from ..ops.counter import ctr56_add
from ..ops.gf128 import blocks_to_bits
from ..ops.mac import ghash_fold_rows, halving_table, masked_xor, mul_by_table
from ..utils.bytesio import BLOCK, u32_tensor, verify_tag
from ..utils.keycache import key_cache
from .bulk import _enc1_batch, gcm_decrypt_batch, gcm_encrypt_batch

# Target number of chain lanes (message segments) per batch.  K10 runs one
# thread per lane through the serial fold, so the lanes must fill the card:
# 32768 lanes are about 8 warps on each of the H100's 132 SMs.  More lanes
# mean more segments: the combine tables (ptabs) cost 2 KB per lane.
_CHAIN_LANES = 32768


def _fast_path_ok(keys, nonces, pts) -> bool:
    return (len({len(k) for k in keys}) == 1
            and all(len(n) == 12 for n in nonces)
            and all(len(p) % BLOCK == 0 for p in pts))


def _chain_shape(b: int, nb: int):
    """(bp, S, L): the batch padded to bp messages and S segments of L
    blocks each, so that the lane count bp*S is a multiple of 32 and at
    least min(_CHAIN_LANES, b*nb)."""
    s = max(1, min(-(-_CHAIN_LANES // b), nb))
    bp = b
    while (bp * s) % 32:
        bp += 1
    return bp, s, -(-nb // s)


@key_cache(maxsize=2)
def _chain_cached(keys_blob: bytes, klen: int, s: int, l: int, device: torch.device):
    """Per-key-set state of the engine, built once: (kpw, htab, rks, ptabs,
    htab_h) on `device` — the lane-packed key planes and per-lane halving
    table of the S segments of every key, the round keys, the combine
    tables ptabs [S,128,B,16] (halvings of H^(L*(S-1-k))) and the
    finalize table htab_h [128,B,16] (halvings of H).  ~(2 + 2*S) KB per
    key."""
    b = len(keys_blob) // klen
    rks_np = expand_keys_batch(np.frombuffer(keys_blob, np.uint8).reshape(b, klen))
    rks = torch.from_numpy(rks_np).to(device)
    h = _enc1_batch(rks, torch.zeros((b, BLOCK), dtype=torch.uint8, device=device))
    kpw = u32_tensor(key_planes_packed(np.repeat(rks_np, s, 0)), device)
    htab = ghash_halving_table(h.repeat_interleave(s, 0))
    htab_h = halving_table(h)
    one = torch.zeros_like(h)
    one[:, 0] = 0x80  # the GHASH field's 1
    hl = one
    for bit in bin(l)[2:]:  # H^L by square-and-multiply
        hl = mul_by_table(hl, halving_table(hl))
        if bit == "1":
            hl = mul_by_table(hl, htab_h)
    tab_hl = halving_table(hl)
    pows = [one]
    for _ in range(s - 1):
        pows.append(mul_by_table(pows[-1], tab_hl))
    ptabs = halving_table(torch.cat(pows[::-1])).reshape(128, s, b, BLOCK)
    return kpw, htab, rks, ptabs.transpose(0, 1).contiguous(), htab_h


def chain_state_from_jax(kpw, htab, h, rks, ptabs, htab_h, *, device="cuda"):
    """The JAX package's per-key-set chain state (seal_batch._chain_cached,
    as numpy arrays) -> the port's, on `device`.  The port keeps H only
    inside htab_h (row 0), so h is checked against it."""
    htab_h = np.asarray(htab_h, np.uint8)
    if not np.array_equal(htab_h[0], np.asarray(h, np.uint8)):
        raise ValueError("chain_state_from_jax: h disagrees with htab_h")

    def u8(a):
        return torch.from_numpy(np.array(a, np.uint8)).to(device)

    return (u32_tensor(kpw, device), u32_tensor(htab, device), u8(rks),
            u8(ptabs), u8(htab_h))


def _chain_core(kpw, htab, c0v, blocks_v, srcm, initm, initv, nblk, init,
                lenb, ej0, ptabs, htab_h, s: int, l: int, decrypt: bool):
    """One K10 launch over the bp*S lanes, then the segment combine and the
    length-block finalize.  Returns (out [bp*S, L, 16], tags [bp, 16])."""
    bv = blocks_v.shape[0]
    bp = bv // s
    dev = blocks_v.device
    ones = torch.full((l, bv // 32), -1, dtype=torch.int32, device=dev)
    zeros = torch.zeros((bv, BLOCK), dtype=torch.uint8, device=dev)
    tailv = torch.full((bv, BLOCK), 0xFF, dtype=torch.uint8, device=dev)
    out, gseg = gcm_chain_fused_raw(kpw, htab, c0v, zeros, blocks_v, ones,
                                    torch.zeros_like(ones), srcm, initm, tailv,
                                    initv, decrypt)
    # G = XOR_s gseg[:, s] * H^(L*(S-1-s)): one masked XOR over (s, bit)
    bits = blocks_to_bits(gseg.reshape(bp, s, BLOCK)).permute(1, 2, 0).bool()
    g = masked_xor(bits.reshape(s * 128, bp), ptabs.reshape(s * 128, bp, BLOCK))
    # empty messages get no injection; their AAD fold enters here instead
    g = g ^ torch.where((nblk == 0)[:, None], init, 0)
    return out, ej0 ^ mul_by_table(g ^ lenb, htab_h)


def _chain_run(keys, nonces, aads, datas, decrypt: bool, device):
    """Shared seal/open body: host prep (right-aligned spans, counter
    bases, lane masks, length blocks), K10 and the combine, then the
    per-message spans.  Returns (out uint8[bp, span*16], tags, ns, span)."""
    dev = torch.device(device)
    b = len(keys)
    ns = np.array([len(d) // BLOCK for d in datas], np.int64)
    nb = max(int(ns.max()), 1)
    bp, s, l = _chain_shape(b, nb)
    span = s * l
    keys_p = keys + [keys[-1]] * (bp - b)
    kpw, htab, rks, ptabs, htab_h = _chain_cached(b"".join(keys_p), len(keys[0]), s, l, dev)

    nsp = np.concatenate([ns, np.zeros(bp - b, np.int64)])
    front = span - nsp  # first data position of each message
    j0 = np.zeros((bp, BLOCK), np.uint8)
    j0[:b, :12] = np.frombuffer(b"".join(nonces), np.uint8).reshape(b, 12)
    j0[:, 15] = 1
    buf = np.zeros((bp, span * BLOCK), np.uint8)
    for i in range(b):
        if ns[i]:
            buf[i, BLOCK * front[i]:] = np.frombuffer(datas[i], np.uint8)
    lenb = np.zeros((bp, BLOCK), np.uint8)
    alen = np.array([len(a) for a in aads] + [0] * (bp - b), np.uint64) * 8
    lenb[:, :8] = alen.astype(">u8").view(np.uint8).reshape(bp, 8)
    lenb[:, 8:] = (nsp.astype(np.uint64) * 128).astype(">u8").view(np.uint8).reshape(bp, 8)
    nva = -(-alen.astype(np.int64) // 128)
    aadb = np.zeros((bp, max(int(nva.max()), 1) * BLOCK), np.uint8)
    for i, a in enumerate(aads):
        aadb[i, : len(a)] = np.frombuffer(a, np.uint8)

    j0_t = torch.from_numpy(j0).to(dev)
    base = j0_t.clone()
    base[:, 15] = 2  # J0 + 1: the counter of the first data block
    seg = torch.arange(s, dtype=torch.int64, device=dev) * l
    front_t = torch.from_numpy(front).to(dev)
    c0v = ctr56_add(base[:, None, :], seg[None, :] - front_t[:, None]).reshape(bp * s, BLOCK)
    pos = torch.arange(span, device=dev).reshape(1, s, l)
    valid = (pos >= front_t[:, None, None]).reshape(bp * s, l)
    # inject the AAD fold at each non-empty message's first data position;
    # an empty or padding message points at its own first lane, whose
    # initm bits stay clear
    lane0 = torch.arange(bp, device=dev) * s + torch.where(
        torch.from_numpy(nsp > 0).to(dev), front_t // l, 0)
    nblk = torch.from_numpy(nsp).to(dev)
    inj = torch.zeros((bp * s, l), dtype=torch.bool, device=dev)
    live = nblk > 0
    inj[lane0[live], (front_t % l)[live]] = True

    init = ghash_fold_rows(htab_h, torch.zeros((bp, BLOCK), dtype=torch.uint8, device=dev),
                           torch.from_numpy(aadb.reshape(bp, -1, BLOCK)).to(dev), nva)
    initv = torch.zeros((bp * s, BLOCK), dtype=torch.uint8, device=dev)
    initv[lane0] = torch.where(live[:, None], init, 0)
    out, tags = _chain_core(
        kpw, htab, c0v, torch.from_numpy(buf.reshape(bp * s, l, BLOCK)).to(dev),
        pack_lane_bits(valid.T), pack_lane_bits(inj.T), initv, nblk, init,
        torch.from_numpy(lenb).to(dev), _enc1_batch(rks, j0_t), ptabs, htab_h,
        s, l, decrypt)
    return out.reshape(bp, span * BLOCK).cpu().numpy(), tags.cpu().numpy(), ns, span


def gcm_seal_batch_chain(keys, nonces, aads, pts, tag_len: int = 16, *,
                         device="cuda") -> list[bytes]:
    """Multi-key GCM seal through the value-chain engine (fast-path
    batches only)."""
    out, tags, ns, span = _chain_run(keys, nonces, aads, pts, False, device)
    return [out[i, BLOCK * (span - n):].tobytes() + tags[i, :tag_len].tobytes()
            for i, n in enumerate(ns)]


def gcm_open_batch_chain(keys, nonces, aads, cts, tags_in, tag_len: int = 16, *,
                         device="cuda") -> list[bytes | None]:
    """Multi-key GCM open through the value-chain engine: each tag is
    verified before its message is released."""
    out, tags, ns, span = _chain_run(keys, nonces, aads, cts, True, device)
    return [out[i, BLOCK * (span - n):].tobytes()
            if verify_tag(tags[i, :tag_len], tags_in[i]) else None
            for i, n in enumerate(ns)]


def gcm_seal_batch(keys, nonces, aads, pts, tag_len: int = 16, *,
                   device="cuda") -> list[bytes]:
    """AES-GCM over B messages under B keys -> [ct || tag] per message.
    One key size, 12-byte nonces and whole-block messages take the
    value-chain engine; any other batch the ragged engine."""
    keys = [bytes(k) for k in keys]
    if not keys:
        return []
    nonces = [bytes(n) for n in nonces]
    aads = [bytes(a) for a in aads]
    pts = [bytes(p) for p in pts]
    if not _fast_path_ok(keys, nonces, pts):
        return gcm_encrypt_batch(keys, nonces, aads, pts, tag_len, device=device)
    return gcm_seal_batch_chain(keys, nonces, aads, pts, tag_len, device=device)


def gcm_open_batch(keys, nonces, aads, ct_tags, tag_len: int = 16, *,
                   device="cuda") -> list[bytes | None]:
    """Batched multi-key GCM open, verify before release per message: a
    message whose tag fails comes back as None."""
    keys = [bytes(k) for k in keys]
    if not keys:
        return []
    nonces = [bytes(n) for n in nonces]
    aads = [bytes(a) for a in aads]
    data = [bytes(c) for c in ct_tags]
    cts = [d[: len(d) - tag_len] for d in data]
    tags = [d[len(d) - tag_len:] for d in data]
    if not _fast_path_ok(keys, nonces, cts):
        return gcm_decrypt_batch(keys, nonces, aads, data, tag_len, device=device)
    return gcm_open_batch_chain(keys, nonces, aads, cts, tags, tag_len, device=device)
