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

The JAX package's matrix-GHASH core (`_seal_batch_core`: a window of Wm
stream rows per message, the cipher on K9's uniform entry
ops/multikey.ctrw_fused_multikey, and per-key GF(2) power tables probed
from the in-stream H, contracted as float64 products) is kept below as the
engine of the dp-sharded twin parallel/batch.seal_batch_sharded_fn; the
public batch API does not route to it, as in the JAX package on its TPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.bitslice import key_planes_batch, key_planes_packed
from ..core.keyschedule import expand_keys_batch
from ..ops.chain import gcm_chain_fused_raw, ghash_halving_table, pack_lane_bits
from ..ops.counter import ctr56_add
from ..ops.gf128 import _bits_np, _unit_blocks, bits_to_blocks, blocks_to_bits, mul_gf128
from ..ops.ghash_bulk import _combine_logdepth, _gf2_matmul_i8
from ..ops.mac import ghash_fold_rows, halving_table, masked_xor, mul_by_table
from ..ops.multikey import ctrw_fused_multikey, mk_window_words
from ..utils.bytesio import BLOCK, i32_from_u32, u32_tensor, verify_tag
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


# -- the matrix-GHASH multi-key core (the engine of the dp-sharded twin) ------

_M32 = 0xFFFFFFFF
# messages per float64 contraction: bounds the products' memory (a key's W1
# is 4 MiB as float64)
_GF2_CHUNK = 64


def _bswap32(x: torch.Tensor) -> torch.Tensor:
    """Byte swap of uint32 values held in int64."""
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8) | ((x >> 8) & 0xFF00)
            | ((x >> 24) & 0xFF))


def _mm_gf2_batch(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Batched GF(2) product of 0/1 operands [B, m, k] x [B, k, n] -> int8
    (ops/ghash_bulk's exact float64 product), _GF2_CHUNK of the batch at a
    time."""
    return torch.cat([_gf2_matmul_i8(a[i:i + _GF2_CHUNK], c[i:i + _GF2_CHUNK])
                      for i in range(0, a.shape[0], _GF2_CHUNK)]).to(torch.int8)


def _mh_batch(h_blocks: torch.Tensor) -> torch.Tensor:
    """Per-key M_H int8[B,128,128] probed from H uint8[B,16] on its device:
    column j is mulGF128(H, e_j) through the batched bit-serial oracle."""
    b = h_blocks.shape[0]
    unit = torch.from_numpy(_unit_blocks()).to(h_blocks.device).expand(b, 128, BLOCK)
    cols = mul_gf128(h_blocks[:, None, :], unit)  # [B, 128, 16]
    return blocks_to_bits(cols).transpose(1, 2).to(torch.int8)


def _powers_t(base: torch.Tensor, first: torch.Tensor) -> list[torch.Tensor]:
    """[first, base @ first, ..., base^31 @ first] over GF(2)."""
    pows = [first]
    for _ in range(31):
        pows.append(_mm_gf2_batch(base, pows[-1]))
    return pows


def _tables_batch(m: torch.Tensor):
    """Per-key two-level GHASH tables on m's device, in the standard bit
    order: w1 int8[B, 4096, 128] (row block j = (M^(32-j))^T), w2 int8[B,
    4096, 128] (row block j = (M^(32*(31-j)))^T), m_outer int8[B,128,128] =
    M^1024."""
    b = m.shape[0]
    pows = _powers_t(m, m)                                   # M^1 .. M^32
    w1 = torch.stack(pows[::-1], 1).transpose(2, 3).reshape(b, 32 * 128, 128)
    m32 = pows[31]
    eye = torch.eye(128, dtype=torch.int8, device=m.device).expand(b, 128, 128)
    pows2 = _powers_t(m32, eye)                              # M32^0 .. M32^31
    w2 = torch.stack(pows2[::-1], 1).transpose(2, 3).reshape(b, 32 * 128, 128)
    return w1.contiguous(), w2.contiguous(), _mm_gf2_batch(m32, pows2[31])


def _stream_bits(words: torch.Tensor) -> torch.Tensor:
    """int32 [N, 128] stream -> int8 [N*32, 128] per-block bit rows."""
    blocks = words.contiguous().view(torch.uint8).reshape(-1, BLOCK)
    return blocks_to_bits(blocks).to(torch.int8)


def _seal_body(kp_stack, j0w, front, mask, sel, len_bits, ptw, b: int, wm: int,
               tables=None):
    """The matrix-GHASH core over B messages, a window of Wm stream rows
    each: kp_stack int32[B*(R+1)*128, 1] (stacked key planes), j0w int32[B,4]
    (J0's little-endian words), front int32[B] (each window's first data
    position), mask/sel int8[B*32*Wm] (per position: folded or not, input or
    output side), len_bits int8[B,128], ptw int32[B*Wm,128].  Position 0
    ciphers the zero block (H), position 1 J0 (E(J0)); AAD and data sit
    right-aligned at the window's end, so the fold needs no adjust.  The
    cipher is K9's uniform entry; tables=None derives each key's GHASH
    tables from the in-stream H, a (m, w1, w2, m_outer) tuple skips that.
    Returns (out stream int32[B*Wm,128], tags uint8[B,16])."""
    dev = ptw.device
    rows = b * wm
    lane = torch.arange(128, dtype=torch.int64, device=dev)
    jj, k = lane // 4, lane % 4
    row = torch.arange(rows, dtype=torch.int64, device=dev)
    msg = row // wm
    p = (row % wm)[:, None] * 32 + jj[None, :]              # position of each word
    j0full = (j0w.to(torch.int64) & _M32)[msg][:, k]        # lane l -> word l % 4
    ctr = (p - front.to(torch.int64)[msg][:, None] + 2) & _M32  # the data region's counter
    w3 = _bswap32(torch.where(p < 2, p, ctr))
    w012 = torch.where(p < 1, 0, j0full)
    ctrw = i32_from_u32(torch.where(k == 3, w3, w012))
    outw = ctrw_fused_multikey(kp_stack, ctrw, ptw, b)

    win = outw.view(torch.int32).reshape(b, wm, 128)
    h_blocks = win[:, 0, 0:4].contiguous().view(torch.uint8).reshape(b, BLOCK)
    ej0_bits = blocks_to_bits(win[:, 0, 4:8].contiguous().view(torch.uint8).reshape(b, BLOCK))
    if tables is None:
        m = _mh_batch(h_blocks)
        w1, w2, m_outer = _tables_batch(m)
    else:
        m, w1, w2, m_outer = tables

    # select the words before the bit expansion: sel/mask are per block, so
    # a word (lane l = word l%4 of block 32*row + l//4) needs a x4 repeat
    selr = sel.reshape(rows, 32).repeat_interleave(4, dim=1)
    maskr = mask.reshape(rows, 32).repeat_interleave(4, dim=1)
    wsel = torch.where(selr != 0, ptw.view(torch.int32), outw.view(torch.int32))
    wsel = torch.where(maskr != 0, wsel, 0)
    bits = _stream_bits(wsel)
    s1 = _mm_gf2_batch(bits.reshape(b, wm, 32 * 128), w1)      # [B, Wm, 128]
    pad = (-wm) % 32
    s1 = torch.nn.functional.pad(s1, (0, 0, pad, 0))
    s2 = _mm_gf2_batch(s1.reshape(b, (wm + pad) // 32, 32 * 128), w2)
    acc = _combine_logdepth(s2, m_outer).to(torch.int8)
    g = _mm_gf2_batch(m, (acc ^ len_bits)[:, :, None])[:, :, 0]
    return outw, bits_to_blocks(ej0_bits ^ g.to(torch.uint8))


def _seal_batch_core(kp_stack, j0w, front, mask, sel, len_bits, ptw, b: int, wm: int):
    """Cold-tenant core: tables derived in line (single-use keys)."""
    return _seal_body(kp_stack, j0w, front, mask, sel, len_bits, ptw, b, wm)


def _seal_batch_core_warm(kp_stack, j0w, front, mask, sel, len_bits, ptw, tables,
                          b: int, wm: int):
    """Warm-tenant core: per-key GHASH tables passed in (_tables_cached)."""
    return _seal_body(kp_stack, j0w, front, mask, sel, len_bits, ptw, b, wm, tables=tables)


def _derive_tables(h_blocks: torch.Tensor):
    """Per-key GHASH machinery from H = E_K(0) uint8[B,16]: (M_H, w1, w2,
    m_outer) on H's device."""
    m = _mh_batch(h_blocks)
    return (m, *_tables_batch(m))


@key_cache(maxsize=2)
def _tables_cached(keys_blob: bytes, klen: int, device: torch.device):
    """_derive_tables of a key set, memoized per key set and device (w1 and
    w2 are 1 MiB a key, so the cache stays tiny); purged by
    purge_key_caches()."""
    b = len(keys_blob) // klen
    rks = torch.from_numpy(expand_keys_batch(
        np.frombuffer(keys_blob, np.uint8).reshape(b, klen))).to(device)
    h = _enc1_batch(rks, torch.zeros((b, BLOCK), dtype=torch.uint8, device=device))
    return _derive_tables(h)


def _prep(keys, nonces, aads, datas, *, device="cuda"):
    """The core's host prep: each message's window (AAD and data
    right-aligned), masks, fronts and length bits, and the key planes built
    on `device` from the round keys -> (b, wm, span, ns, front_np,
    kp_stack, j0w, front, mask, sel, len_bits, ptw), the tensors on
    `device`.  12-byte nonces, whole-block data, one key size."""
    dev = torch.device(device)
    b = len(keys)
    ns = [len(d) // BLOCK for d in datas]
    nas = [-(-len(a) // BLOCK) for a in aads]
    wm = mk_window_words(max(n + na + 2 for n, na in zip(ns, nas)))
    span = 32 * wm
    buf = np.zeros((b, span * 4), np.uint32)
    mask = np.zeros((b, span), np.int8)
    sel = np.zeros((b, span), np.int8)
    len_bits = np.zeros((b, 128), np.uint8)
    front = np.zeros(b, np.int32)
    j0w = np.zeros((b, 4), np.uint32)
    for i, (a, d) in enumerate(zip(aads, datas)):
        n, na = ns[i], nas[i]
        f = span - n
        front[i] = f
        ab = np.zeros(na * BLOCK, np.uint8)
        ab[: len(a)] = np.frombuffer(bytes(a), np.uint8)
        buf[i, 4 * (f - na): 4 * f] = ab.view(np.uint32)
        buf[i, 4 * f: 4 * (f + n)] = np.frombuffer(bytes(d), np.uint32)
        mask[i, f - na:] = 1
        sel[i, f - na: f] = 1  # AAD bits always come from the input side
        lb = np.zeros(BLOCK, np.uint8)
        lb[:8] = np.frombuffer((len(a) * 8).to_bytes(8, "big"), np.uint8)
        lb[8:] = np.frombuffer((n * BLOCK * 8).to_bytes(8, "big"), np.uint8)
        len_bits[i] = _bits_np(lb)
        j0 = np.zeros(BLOCK, np.uint8)
        j0[:12] = np.frombuffer(bytes(nonces[i]), np.uint8)
        j0[15] = 1
        j0w[i] = j0.view(np.uint32)
    rks = torch.from_numpy(expand_keys_batch(
        np.frombuffer(b"".join(bytes(k) for k in keys), np.uint8).reshape(b, len(keys[0])))).to(dev)
    kp_stack = key_planes_batch(rks).reshape(-1, 1)
    return (b, wm, span, ns, front, kp_stack, u32_tensor(j0w, dev),
            torch.from_numpy(front).to(dev), torch.from_numpy(mask.reshape(-1)).to(dev),
            torch.from_numpy(sel.reshape(-1)).to(dev),
            torch.from_numpy(len_bits.astype(np.int8)).to(dev),
            u32_tensor(buf.reshape(b * wm, 128), dev))
