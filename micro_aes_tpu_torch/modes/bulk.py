"""Batched multi-message engines: B independent (key, nonce, message) tuples
in a fixed number of device calls, whatever B, with mixed key sizes (split
into one sub-batch per size).

  * Ragged batch AES-GCM: any nonce length and any message length; the
    general fallback of the multi-key batch engine (modes/seal_batch), and
    the GCM part of the JAX package's modes/bulk.py.  The keystreams of all
    messages (E(J0) riding in front) go through K9 (ops/multikey.
    ctrw_fused_multikey), one launch per key size; H = E_K(0) per key and
    the GHASH folds (ops/mac.ghash_fold_batch, a loop over the longest AAD
    + message on the device) are plain PyTorch.
  * `cmac_batch`: AES-CMAC of B messages, one K13 CBC-MAC launch per key
    size (ops/mac.cbcmac_fold_batch_auto).
  * `xts_batch`: XEX over B messages of one whole-block length, the body
    through K9 in either direction.
  * `cipher_blocks_multikey` (host arrays) and `cipher_blocks_multikey_dev`
    (tensors): E_k or D_k of a block array with a key per row, one K9
    launch per key size; the chain batches (modes/chain_bulk) use them too.
  * `ccm_*_batch` and `eax_*_batch`: the small MAC prefixes (CCM's B0 and
    AAD, EAX's nonce and header OMACs and the ciphertext OMAC's tweak block)
    as K13 folds, then one pass of K11 (ops/aead_kernels.aead_chain_fused)
    per key size that makes the keystream XOR and folds the payload's MAC.
    An all-empty batch stops at the folds (and K9 for CCM's E(A0)).
  * `siv_*_batch`: S2V's AAD side as one K13 fold, then one pass of K12
    (siv_seal_chain_fused / siv_open_chain_fused) per key size; an
    all-empty batch needs only its S2V, by CMAC folds.
"""
from __future__ import annotations

import functools
import inspect

import numpy as np
import torch

from ..core.bitslice import key_planes_batch
from ..core.cipher import encrypt_blocks
from ..core.keyschedule import expand_keys_batch
from ..ops.aead_kernels import aead_chain_fused, siv_open_chain_fused, siv_seal_chain_fused
from ..ops.counter import ctr56_add
from ..ops.mac import (
    _kpw_cached,
    cbcmac_fold_batch_auto,
    double_be_np,
    double_le_np,
    ghash_fold_batch,
)
from ..ops.multikey import ctrw_fused_multikey, mk_window_words
from ..utils.bytesio import BLOCK, to_u8, verify_tag


def stack_round_keys(keys: list[bytes]) -> np.ndarray:
    """uint8[B, R+1, 16] round keys of B keys of one size (one vectorized
    expansion, core/keyschedule.expand_keys_batch)."""
    keys = [bytes(k) for k in keys]
    if len({len(k) for k in keys}) != 1:
        raise ValueError("stack_round_keys needs keys of one size")
    return expand_keys_batch(np.frombuffer(b"".join(keys), np.uint8)
                             .reshape(len(keys), len(keys[0])))


def _regroup_mixed_keys(nlists: int):
    """Make a batch engine accept mixed AES key sizes in one call.

    Round-key stacks of different sizes have different round counts and do
    not stack, so a mixed batch is split into per-size sub-batches (at most
    3) and the results are put back in order.  `nlists` counts the
    per-message list arguments after `keys`; the others pass through.
    Arguments are bound by signature, so keyword lists regroup too.  An
    empty batch returns []."""
    def deco(fn):
        sig = inspect.signature(fn)
        params = list(sig.parameters)

        @functools.wraps(fn)
        def wrapper(*args, **kw):
            bound = sig.bind(*args, **kw)
            bound.apply_defaults()
            keys = [bytes(k) for k in bound.arguments[params[0]]]
            if not keys:
                return []
            sizes = sorted({len(k) for k in keys})
            if len(sizes) == 1:
                bound.arguments[params[0]] = keys
                return fn(*bound.args, **bound.kwargs)
            lists = [list(bound.arguments[p]) for p in params[1: 1 + nlists]]
            out: list = [None] * len(keys)
            for klen in sizes:
                idxs = [i for i, k in enumerate(keys) if len(k) == klen]
                bound.arguments[params[0]] = [keys[i] for i in idxs]
                for p, lst in zip(params[1: 1 + nlists], lists):
                    bound.arguments[p] = [lst[i] for i in idxs]
                sub = fn(*bound.args, **bound.kwargs)
                for j, i in enumerate(idxs):
                    out[i] = sub[j]
            return out
        return wrapper
    return deco


def cipher_blocks_multikey_dev(keys: list, blocks: torch.Tensor,
                               decrypt: bool = False) -> torch.Tensor:
    """E_k (D_k when decrypt) over uint8[B, nb, 16] with a key per row, on
    blocks' device -> uint8[B, nb, 16]: one K9 launch per key size.  Only
    the round keys cross to the device; their broadcast planes are built
    there."""
    keys = [bytes(k) for k in keys]
    sizes = sorted({len(k) for k in keys})
    if len(sizes) > 1:  # round counts differ: one launch per size
        out = torch.empty_like(blocks)
        for klen in sizes:
            idxs = [i for i, k in enumerate(keys) if len(k) == klen]
            sel = torch.as_tensor(idxs, device=blocks.device)
            out[sel] = cipher_blocks_multikey_dev([keys[i] for i in idxs], blocks[sel], decrypt)
        return out
    b, nb = blocks.shape[0], blocks.shape[1]
    wm = mk_window_words(nb)
    words = blocks.contiguous().view(torch.int32).reshape(b, nb * 4)
    ctr = torch.nn.functional.pad(words, (0, wm * 128 - nb * 4)).reshape(b * wm, 128)
    rks = torch.from_numpy(stack_round_keys(keys)).to(blocks.device)
    kp_stack = key_planes_batch(rks).reshape(-1, 1)
    out = ctrw_fused_multikey(kp_stack, ctr, torch.zeros_like(ctr), b, decrypt)
    o = out.reshape(b, wm * 128)[:, : nb * 4].contiguous()
    return o.view(torch.uint8).reshape(b, nb, BLOCK)


def cipher_blocks_multikey(keys: list, blocks: np.ndarray, decrypt: bool = False, *,
                           device="cuda") -> np.ndarray:
    """cipher_blocks_multikey_dev on host arrays: uint8[B, nb, 16] in and
    out, computed on `device`."""
    x = torch.from_numpy(np.ascontiguousarray(blocks, np.uint8)).to(device)
    return cipher_blocks_multikey_dev(keys, x, decrypt).cpu().numpy()


def _enc1_batch(rks: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """E_{k_i}(block_i) for B (round keys uint8[B,R+1,16], block uint8[B,16])
    pairs with the byte-oriented cipher (B blocks: H and E(J0) per key)."""
    return encrypt_blocks(rks.transpose(0, 1), blocks)


def _ragged_blocks(datas: list[np.ndarray], nblocks: int) -> np.ndarray:
    out = np.zeros((len(datas), nblocks * BLOCK), np.uint8)
    for i, d in enumerate(datas):
        out[i, : len(d)] = d
    return out.reshape(len(datas), nblocks, BLOCK)


def _len_block(abits: int, cbits: int) -> np.ndarray:
    return np.frombuffer(abits.to_bytes(8, "big") + cbits.to_bytes(8, "big"), np.uint8)


def _batch_j0(nonces: list[np.ndarray], h: torch.Tensor) -> torch.Tensor:
    """Per-message J0 on h's device: nonce || 0^31 || 1 for 12-byte nonces,
    GHASH(nonce, lengths) for the others (batched)."""
    b = len(nonces)
    j0 = np.zeros((b, BLOCK), np.uint8)
    long_idx = [i for i, n in enumerate(nonces) if len(n) != 12]
    for i, n in enumerate(nonces):
        if len(n) == 12:
            j0[i, :12] = n
            j0[i, 15] = 1
    j0 = torch.from_numpy(j0).to(h.device)
    if long_idx:
        nbs = [-(-len(nonces[i]) // BLOCK) for i in long_idx]
        ivb = _ragged_blocks([nonces[i] for i in long_idx], max(nbs) + 1)
        for k, i in enumerate(long_idx):
            ivb[k, nbs[k]] = _len_block(0, 8 * len(nonces[i]))
        sel = torch.as_tensor(long_idx, device=h.device)
        j0[sel] = ghash_fold_batch(h[sel], torch.zeros_like(h[sel]),
                                   torch.from_numpy(ivb).to(h.device),
                                   [n + 1 for n in nbs])
    return j0


def _batch_tag_ghash(h: torch.Tensor, aads: list[np.ndarray],
                     cts: list[np.ndarray], nks: int) -> torch.Tensor:
    """GHASH(AAD, CT, lengths) of every message, batched, on h's device."""
    b = len(aads)
    maad = max(-(-len(a) // BLOCK) for a in aads)
    gb = np.zeros((b, maad + nks + 1, BLOCK), np.uint8)
    nv = np.zeros(b, np.int64)
    for i in range(b):
        a, c = aads[i], cts[i]
        na, nc = -(-len(a) // BLOCK), -(-len(c) // BLOCK)
        gb[i, :na].reshape(-1)[: len(a)] = a
        gb[i, na: na + nc].reshape(-1)[: len(c)] = c
        gb[i, na + nc] = _len_block(8 * len(a), 8 * len(c))
        nv[i] = na + nc + 1
    return ghash_fold_batch(h, torch.zeros_like(h), torch.from_numpy(gb).to(h.device), nv)


def _keystreams(keys, nonces, nks: int, dev):
    """(H, E(J0) and the nks keystream blocks after J0) per message."""
    rks = torch.from_numpy(stack_round_keys(keys)).to(dev)
    h = _enc1_batch(rks, torch.zeros((len(keys), BLOCK), dtype=torch.uint8, device=dev))
    j0 = _batch_j0(nonces, h)
    steps = torch.arange(nks + 1, dtype=torch.int64, device=dev)
    ks_all = cipher_blocks_multikey_dev(keys, ctr56_add(j0[:, None, :], steps))
    return h, ks_all[:, 0], ks_all[:, 1:].reshape(len(keys), nks * BLOCK)


@_regroup_mixed_keys(3)
def gcm_encrypt_batch(keys: list[bytes], nonces: list[bytes], aads: list[bytes],
                      pts: list[bytes], tag_len: int = 16, *,
                      device="cuda") -> list[bytes]:
    """AES-GCM over B independent messages -> [ct || tag] per message."""
    dev = torch.device(device)
    aads = [to_u8(a) for a in aads]
    pts = [to_u8(p) for p in pts]
    nonces = [to_u8(n) for n in nonces]
    nks = -(-max(len(p) for p in pts) // BLOCK)
    h, ek_j0, ks = _keystreams(keys, nonces, nks, dev)
    pt_all = torch.from_numpy(_ragged_blocks(pts, nks).reshape(len(pts), -1)).to(dev)
    ct_all = (pt_all ^ ks).cpu().numpy()
    cts = [ct_all[i, : len(p)] for i, p in enumerate(pts)]
    tags = (ek_j0 ^ _batch_tag_ghash(h, aads, cts, nks)).cpu().numpy()
    return [cts[i].tobytes() + tags[i, :tag_len].tobytes() for i in range(len(pts))]


@_regroup_mixed_keys(3)
def gcm_decrypt_batch(keys: list[bytes], nonces: list[bytes], aads: list[bytes],
                      ct_tags: list[bytes], tag_len: int = 16, *,
                      device="cuda") -> list[bytes | None]:
    """Batched GCM open with the reference's verify-before-decrypt order
    (micro_aes.c:1204-1209): a message whose tag fails comes back as None
    and its keystream is discarded."""
    dev = torch.device(device)
    aads = [to_u8(a) for a in aads]
    nonces = [to_u8(n) for n in nonces]
    data = [to_u8(c) for c in ct_tags]
    cts = [d[: len(d) - tag_len] for d in data]
    tags = [d[len(d) - tag_len:] for d in data]
    nks = -(-max(len(c) for c in cts) // BLOCK)
    h, ek_j0, ks = _keystreams(keys, nonces, nks, dev)
    expects = (ek_j0 ^ _batch_tag_ghash(h, aads, cts, nks)).cpu().numpy()
    ks = ks.cpu().numpy()
    return [(c ^ ks[i, : len(c)]).tobytes()
            if verify_tag(expects[i, :tag_len], tags[i]) else None
            for i, c in enumerate(cts)]


def _cmac_subkeys(rks: np.ndarray, dev) -> tuple[np.ndarray, np.ndarray]:
    """(K1, K2) of every key of a round-key stack (getSubkeys, micro_aes.c:
    593-604): E_k(0) in one call of the byte cipher on `dev`, the doublings
    on the host."""
    zeros = torch.zeros((rks.shape[0], BLOCK), dtype=torch.uint8, device=dev)
    k1 = double_be_np(_enc1_batch(torch.from_numpy(rks).to(dev), zeros).cpu().numpy())
    return k1, double_be_np(k1)


def _cmac_batch(rks: np.ndarray, k1: np.ndarray, k2: np.ndarray, msgs: list[np.ndarray],
                dev) -> torch.Tensor:
    """cMac (micro_aes.c:576-590) of B host messages under a round-key stack
    with its subkeys, one batched CBC-MAC fold (K13) -> uint8[B,16] on
    `dev`."""
    b = len(msgs)
    m = max(-(-len(x) // BLOCK) or 1 for x in msgs)
    blocks = np.zeros((b, m, BLOCK), np.uint8)
    nv = np.zeros(b, np.int32)
    for i, x in enumerate(msgs):
        n = len(x)
        s = (n - 1) % BLOCK + 1 if n else 0
        nb = (n - s) // BLOCK
        blocks[i].reshape(-1)[: n] = x
        last = blocks[i, nb]
        if s < BLOCK:
            last[s] ^= 0x80
            last ^= k2[i]
        else:
            last ^= k1[i]
        nv[i] = nb + 1
    zeros = torch.zeros((b, BLOCK), dtype=torch.uint8, device=dev)
    return cbcmac_fold_batch_auto(rks, zeros, torch.from_numpy(blocks).to(dev), nv)


@_regroup_mixed_keys(1)
def cmac_batch(keys: list[bytes], msgs: list[bytes], *, device="cuda") -> list[bytes]:
    """AES-CMAC over B independent messages: the subkeys of all keys in one
    call of the byte cipher, then one batched CBC-MAC fold (K13)."""
    dev = torch.device(device)
    rks = stack_round_keys(keys)
    k1, k2 = _cmac_subkeys(rks, dev)
    out = _cmac_batch(rks, k1, k2, [to_u8(m) for m in msgs], dev)
    return [bytes(t) for t in out.cpu().numpy()]


@_regroup_mixed_keys(2)
def xts_batch(keys: list[bytes], tweaks: list[bytes], datas: list[bytes], encrypt: bool,
              *, device="cuda") -> list[bytes]:
    """Batched XEX over B messages of one whole-block length: keys are
    key1 || key2, tweaks 16-byte blocks; T_0 = E_key2(tweak) per message
    with the byte cipher, the doublings on the host, the body through K9
    (D_key1 when not encrypting)."""
    dev = torch.device(device)
    b = len(keys)
    klen = len(keys[0]) // 2
    n = len(datas[0]) // BLOCK
    rks2 = torch.from_numpy(stack_round_keys([k[klen:] for k in keys])).to(dev)
    tw0 = torch.from_numpy(np.stack([to_u8(t)[:BLOCK] for t in tweaks])).to(dev)
    t = _enc1_batch(rks2, tw0).cpu().numpy()
    tw = np.zeros((b, n, BLOCK), np.uint8)
    for i in range(n):
        tw[:, i] = t
        t = double_le_np(t)
    x = np.stack([to_u8(d).reshape(n, BLOCK) for d in datas])
    y = cipher_blocks_multikey([k[:klen] for k in keys], x ^ tw, not encrypt, device=dev) ^ tw
    return [bytes(y[i].reshape(-1)) for i in range(b)]


# -- the one-pass AEAD batches: CCM and EAX on K11, SIV on K12 --------------

def _tail_mask_np(lens) -> np.ndarray:
    """uint8[B,16] byte-validity mask of each message's final MAC block:
    0xFF below s = (len-1) % 16 + 1 (a whole final block masks nothing);
    zero rows for empty messages (never applied: their nvalid is 0)."""
    lens = np.asarray(lens, np.int64)
    s = np.where(lens > 0, (lens - 1) % BLOCK + 1, 0)
    return ((np.arange(BLOCK)[None, :] < s[:, None]) * 0xFF).astype(np.uint8)


def _rows(a, pad: int, dev) -> torch.Tensor:
    """uint8[B,...] (host array or tensor) on `dev`, padded with `pad` zero
    rows."""
    t = a.to(dev) if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if pad:
        t = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
    return t.contiguous()


def _lane_keys(rks: np.ndarray, pad: int, dev) -> torch.Tensor:
    """K13-style lane-packed key planes of a round-key stack padded to a
    multiple of 32 lanes with its last key (cached per stack)."""
    if pad:
        rks = np.concatenate([rks, np.repeat(rks[-1:], pad, axis=0)])
    return _kpw_cached(rks.tobytes(), rks.shape[0], rks.shape[1], dev)


def _aead_fused_run(kind: str, rks: np.ndarray, c0, init, blocks: torch.Tensor, nvalid,
                    tail, lastadd, decrypt: bool):
    """Pad the batch to 32 lanes and run K11 (ops/aead_kernels.
    aead_chain_fused) on blocks' device -> (out uint8[B,nb,16], tag
    uint8[B,16]), sliced back to B."""
    dev = blocks.device
    b = blocks.shape[0]
    pad = (-b) % 32
    out, tag = aead_chain_fused(
        kind, _lane_keys(rks, pad, dev), _rows(c0, pad, dev), _rows(init, pad, dev),
        _rows(blocks, pad, dev), _rows(np.asarray(nvalid, np.int32), pad, dev),
        _rows(tail, pad, dev), _rows(lastadd, pad, dev), decrypt)
    return out[:b], tag[:b]


def _eax_last_np(k1, k2, t: int, lens):
    """The data-independent OMAC constants of EAX's ciphertext side
    (micro_aes.c:1531-1549), for K11: the tweak block [0..0, t] to fold
    first (with K1 in it for an empty message, whose whole OMAC is
    E(T ^ K1)), the final-block XOR (the 0x80 marker and K2 for a partial
    block, K1 for a whole one) and the payload block counts."""
    b = len(lens)
    tweak = np.zeros((b, 1, BLOCK), np.uint8)
    tweak[:, 0, BLOCK - 1] = t
    lastadd = np.zeros((b, BLOCK), np.uint8)
    nv = np.zeros(b, np.int32)
    for i, n in enumerate(lens):
        if not n:
            tweak[i, 0] ^= k1[i]
            continue
        s = (n - 1) % BLOCK + 1
        if s < BLOCK:
            lastadd[i, s] = 0x80
            lastadd[i] ^= k2[i]
        else:
            lastadd[i] = k1[i]
        nv[i] = (n - 1) // BLOCK + 1
    return tweak, lastadd, nv


def _tagged(outs: np.ndarray | None, lens, tags: np.ndarray, tag_len: int) -> list[bytes]:
    return [(outs[i].reshape(-1)[:n].tobytes() if n else b"") + tags[i, :tag_len].tobytes()
            for i, n in enumerate(lens)]


def _verified(outs: np.ndarray | None, lens, expects: np.ndarray, tags: list[np.ndarray],
              tag_len: int) -> list[bytes | None]:
    """A message's plaintext where its tag verifies, else None (constant-time
    compares)."""
    return [(outs[i].reshape(-1)[:n].tobytes() if n else b"")
            if verify_tag(expects[i, :tag_len], tags[i]) else None
            for i, n in enumerate(lens)]


def _eax_run(keys, nonces, aads, datas, decrypt: bool, dev):
    """EAX over B messages of one key size: (out uint8[B,nks,16] on the host,
    or None when every message is empty; N ^ H ^ C tags uint8[B,16])."""
    b = len(keys)
    rks = stack_round_keys(keys)
    k1, k2 = _cmac_subkeys(rks, dev)

    def omac(t, strings):
        """oMac (micro_aes.c:1531-1549): the CMAC of [0..0, t] || data."""
        tweak = np.zeros(BLOCK, np.uint8)
        tweak[-1] = t
        return _cmac_batch(rks, k1, k2, [np.concatenate([tweak, to_u8(x)]) for x in strings],
                           dev)

    n_mac, h_mac = omac(0, nonces), omac(1, aads)
    lens = [len(d) for d in datas]
    tweak, lastadd, nv = _eax_last_np(k1, k2, 2, lens)
    zeros = torch.zeros((b, BLOCK), dtype=torch.uint8, device=dev)
    acc = cbcmac_fold_batch_auto(rks, zeros, torch.from_numpy(tweak).to(dev), np.ones(b, np.int32))
    nks = -(-max(lens) // BLOCK)
    if not nks:  # no payload: OMAC(2; ct) is the tweak fold, and no keystream
        return None, (n_mac ^ h_mac ^ acc).cpu().numpy()
    # one pass of K11: the keystream XOR and the ciphertext OMAC, its last
    # block's K1/K2 and 0x80 applied in the kernel at each message's last step
    blocks = torch.from_numpy(_ragged_blocks(datas, nks)).to(dev)
    out, c_mac = _aead_fused_run("eax", rks, n_mac, acc, blocks, nv, _tail_mask_np(lens),
                                 lastadd, decrypt)
    return out.cpu().numpy(), (n_mac ^ h_mac ^ c_mac).cpu().numpy()


@_regroup_mixed_keys(3)
def eax_encrypt_batch(keys: list[bytes], nonces: list[bytes], aads: list[bytes],
                      pts: list[bytes], tag_len: int = 16, *, device="cuda") -> list[bytes]:
    """AES-EAX over B independent messages -> [ct || tag]: the nonce and
    header OMACs and the ciphertext OMAC's tweak block as K13 folds, then
    one K11 pass that makes the ciphertext and folds its OMAC."""
    pts = [to_u8(p) for p in pts]
    ct, tags = _eax_run(keys, nonces, aads, pts, False, torch.device(device))
    return _tagged(ct, [len(p) for p in pts], tags, tag_len)


@_regroup_mixed_keys(3)
def eax_decrypt_batch(keys: list[bytes], nonces: list[bytes], aads: list[bytes],
                      ct_tags: list[bytes], tag_len: int = 16, *,
                      device="cuda") -> list[bytes | None]:
    """Batched EAX open: K11 folds the ciphertext OMAC while it recovers the
    plaintext; a message whose tag fails comes back as None."""
    data = [to_u8(x) for x in ct_tags]
    cts = [d[: len(d) - tag_len] for d in data]
    pt, expects = _eax_run(keys, nonces, aads, cts, True, torch.device(device))
    return _verified(pt, [len(c) for c in cts], expects, [d[len(d) - tag_len:] for d in data],
                     tag_len)


def _ccm_prefix_batch(iv0s: np.ndarray, aads: list[np.ndarray], ptlens, tag_len: int):
    """B0 and the A-segment of every message (CCMtag, micro_aes.c:
    1222-1256) as array operations, the AAD bytes in one scatter -> (pb
    uint8[B,mp,16], nv1 int32[B] prefix blocks per message).  The payload
    follows at a fresh block boundary."""
    b = len(aads)
    alens = np.array([len(a) for a in aads], np.int64)
    m = iv0s.astype(np.uint8).copy()
    m[:, 0] |= (tag_len - 2) << 2
    m[:, 0] |= np.where(alens > 0, 0x40, 0).astype(np.uint8)
    v = np.asarray(ptlens, np.uint64)
    for i in range(8):  # the BE payload length; zero high bytes XOR nothing
        m[:, 15 - i] ^= ((v >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(np.uint8)
    # the AAD region: a 2-byte length field (6 with the 0xFFFE prefix past
    # 0xFEFF), then the AAD, zero-padded to whole blocks
    hdr = np.where(alens > 0xFEFF, 6, 2)
    na = np.where(alens > 0, -(-(hdr + alens) // BLOCK), 0)
    mp = int(1 + na.max()) if b else 1
    pb = np.zeros((b, mp, BLOCK), np.uint8)
    pb[:, 0] = m
    region = np.zeros((b, (mp - 1) * BLOCK), np.uint8)
    if mp > 1:
        big = alens > 0xFEFF
        region[big, 0], region[big, 1] = 0xFF, 0xFE
        av = alens.astype(np.uint64)
        # the BE length ends at byte hdr-1; for a 2-byte field bytes 2-3 of
        # av are zero, so the XORs that wrap to other columns are no-ops
        for i in range(4):
            region[np.arange(b), hdr - 1 - i] ^= (
                (av >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(np.uint8)
        flat = np.concatenate([np.asarray(a, np.uint8).reshape(-1) for a in aads if len(a)])
        rows = np.repeat(np.arange(b), alens)
        starts = np.repeat(np.cumsum(alens) - alens, alens)
        offs = np.arange(len(flat)) - starts + np.repeat(hdr, alens)
        region[rows, offs] = flat
    pb[:, 1:] = region.reshape(b, mp - 1, BLOCK)
    return pb, (1 + na).astype(np.int32)


def _ccm_run(keys, nonces, aads, datas, nonce_len, tag_len: int, decrypt: bool, dev):
    """CCM over B messages of one key size: (out uint8[B,nks,16] on the host,
    or None when every message is empty; tags uint8[B,16])."""
    from .ccm import _iv0

    b = len(keys)
    rks = stack_round_keys(keys)
    aads = [to_u8(a) for a in aads]
    iv0s = np.stack([_iv0(to_u8(n)[:nonce_len] if nonce_len else to_u8(n)) for n in nonces])
    lens = [len(d) for d in datas]
    # the B0 + AAD prefixes folded from 0: fold(0, [B0, ...]) = fold(E(B0), ...)
    pb, nv1 = _ccm_prefix_batch(iv0s, aads, lens, tag_len)
    zeros = torch.zeros((b, BLOCK), dtype=torch.uint8, device=dev)
    acc = cbcmac_fold_batch_auto(rks, zeros, torch.from_numpy(pb).to(dev), nv1)
    nks = -(-max(lens) // BLOCK)
    if not nks:  # no payload: the tag is E(A0) (by K9) ^ the prefix fold
        ek0 = cipher_blocks_multikey_dev(keys, torch.from_numpy(iv0s[:, None]).to(dev))[:, 0]
        return None, (ek0 ^ acc).cpu().numpy()
    # one pass of K11: E(A0) in its leading step, the keystream XOR and the
    # payload's CBC-MAC continued from the prefix fold
    blocks = torch.from_numpy(_ragged_blocks(datas, nks)).to(dev)
    nvp = np.array([-(-n // BLOCK) for n in lens], np.int32)
    out, tags = _aead_fused_run("ccm", rks, iv0s, acc, blocks, nvp, _tail_mask_np(lens),
                                np.zeros((b, BLOCK), np.uint8), decrypt)
    return out.cpu().numpy(), tags.cpu().numpy()


@_regroup_mixed_keys(3)
def ccm_encrypt_batch(keys: list[bytes], nonces: list[bytes], aads: list[bytes],
                      pts: list[bytes], nonce_len: int | None = None, tag_len: int = 16, *,
                      device="cuda") -> list[bytes]:
    """AES-CCM over B independent messages -> [ct || tag]: the B0 + AAD
    prefixes as one K13 fold, then one K11 pass for the ciphertext and the
    payload's CBC-MAC.  nonce_len=None takes each nonce's own length."""
    pts = [to_u8(p) for p in pts]
    ct, tags = _ccm_run(keys, nonces, aads, pts, nonce_len, tag_len, False,
                        torch.device(device))
    return _tagged(ct, [len(p) for p in pts], tags, tag_len)


@_regroup_mixed_keys(3)
def ccm_decrypt_batch(keys: list[bytes], nonces: list[bytes], aads: list[bytes],
                      ct_tags: list[bytes], nonce_len: int | None = None, tag_len: int = 16,
                      *, device="cuda") -> list[bytes | None]:
    """Batched CCM open, decrypt-then-verify as the reference orders it
    (micro_aes.c:1304-1312): K11 folds the recovered plaintext, masked past
    each message's length; a message whose tag fails comes back as None."""
    data = [to_u8(x) for x in ct_tags]
    cts = [d[: len(d) - tag_len] for d in data]
    pt, expects = _ccm_run(keys, nonces, aads, cts, nonce_len, tag_len, True,
                           torch.device(device))
    return _verified(pt, [len(c) for c in cts], expects, [d[len(d) - tag_len:] for d in data],
                     tag_len)


def _siv_split(keys) -> tuple[list[bytes], list[bytes]]:
    """K1 || K2 -> ([K1], [K2])."""
    keys = [bytes(k) for k in keys]
    return [k[: len(k) // 2] for k in keys], [k[len(k) // 2:] for k in keys]


def _s2v_y(rks1: np.ndarray, k1, k2, aads: list[np.ndarray], dev) -> np.ndarray:
    """The AAD side of S2V (micro_aes.c:1324-1340): Y0 = CMAC(0^16), then
    dbl(Y0) ^ CMAC(aad) where there is an AAD.  Both CMACs of the batch in
    one K13 fold."""
    b = len(aads)
    macs = _cmac_batch(np.concatenate([rks1, rks1]), np.concatenate([k1, k1]),
                       np.concatenate([k2, k2]), [np.zeros(BLOCK, np.uint8)] * b + aads,
                       dev).cpu().numpy()
    y0, amac = macs[:b], macs[b:]
    has_aad = np.array([len(a) > 0 for a in aads])[:, None]
    return np.where(has_aad, double_be_np(y0) ^ amac, y0)


def _s2v_empty(rks1: np.ndarray, aads: list[np.ndarray], dev) -> np.ndarray:
    """S2V of B empty plaintexts (micro_aes.c:1344-1349): the CMAC of
    dbl(y) ^ 0x80 0^15, by CMAC folds (an all-empty batch has nothing for
    K12 to encrypt) -> host uint8[B,16]."""
    k1, k2 = _cmac_subkeys(rks1, dev)
    final = double_be_np(_s2v_y(rks1, k1, k2, aads, dev))
    final[:, 0] ^= 0x80
    return _cmac_batch(rks1, k1, k2, list(final), dev).cpu().numpy()


def _siv_s2v_consts(d, q, y, lens):
    """S2V's data-independent last-block constants for K12 (micro_aes.c:
    1336-1356), per message: the final block's byte mask `tail`, the XOR
    into it `lastadd`, the XOR into the block before it `prevadd` (the
    xorend straddle: with s bytes in a ragged final block, y's last s bytes
    land on it and its first 16 - s on the previous block's tail), and the
    MAC block count.  d, q are the MAC key's CMAC subkeys; a message under
    one block takes dbl(y) ^ pad (c:1344-1349)."""
    b = len(lens)
    tail = np.zeros((b, BLOCK), np.uint8)
    lastadd = np.zeros((b, BLOCK), np.uint8)
    prevadd = np.zeros((b, BLOCK), np.uint8)
    nv = np.zeros(b, np.int32)
    dy = double_be_np(y)
    for i, n in enumerate(lens):
        if n >= BLOCK:
            s = (n - 1) % BLOCK + 1
            nv[i] = (n - 1) // BLOCK + 1
            if s == BLOCK:
                tail[i] = 0xFF
                lastadd[i] = y[i] ^ d[i]
            else:
                tail[i, :s] = 0xFF
                lastadd[i, :s] = y[i, BLOCK - s:]
                lastadd[i, s] ^= 0x80
                lastadd[i] ^= q[i]
                prevadd[i, s:] = y[i, : BLOCK - s]
        else:
            nv[i] = 1
            tail[i, :n] = 0xFF
            lastadd[i] = dy[i]
            lastadd[i, n] ^= 0x80
            lastadd[i] ^= d[i]
    return tail, lastadd, prevadd, nv


def _siv_fused_prep(k1s, k2s, aads, lens, dev):
    """What both K12 runs need: (pad to 32 lanes, nb, the padded lane key
    planes of K1 and K2, tail, lastadd, prevadd and nvalid padded on
    `dev`)."""
    rks1, rks2 = stack_round_keys(k1s), stack_round_keys(k2s)
    d, q = _cmac_subkeys(rks1, dev)
    tail, lastadd, prevadd, nv = _siv_s2v_consts(d, q, _s2v_y(rks1, d, q, aads, dev), lens)
    pad = (-len(k1s)) % 32
    return (pad, int(nv.max()), _lane_keys(rks1, pad, dev), _lane_keys(rks2, pad, dev),
            *(_rows(a, pad, dev) for a in (tail, lastadd, prevadd, nv)))


def _siv_fused_seal_run(k1s, k2s, aads, pts, dev) -> list[tuple[bytes, bytes]]:
    """One K12 seal pass over the batch: the S2V fold, then SIV-CTR."""
    b = len(pts)
    lens = [len(p) for p in pts]
    pad, nb, kpm, kpc, tail, lastadd, prevadd, nv = _siv_fused_prep(k1s, k2s, aads, lens, dev)
    blocks = _rows(_ragged_blocks(pts, nb), pad, dev)
    ct, ivs = siv_seal_chain_fused(kpm, kpc, torch.zeros_like(tail), blocks, nv, tail, lastadd,
                                   prevadd)
    ct, ivs = ct[:b].cpu().numpy(), ivs[:b].cpu().numpy()
    return [(ivs[i].tobytes(), ct[i].reshape(-1)[:n].tobytes()) for i, n in enumerate(lens)]


def _siv_fused_open_run(k1s, k2s, iv_arr: np.ndarray, aads, cts, dev) -> list[bytes | None]:
    """One K12 open pass: SIV-CTR and the S2V fold of the recovered
    plaintext, then the constant-time IV compares (micro_aes.c:1394-1410)."""
    b = len(cts)
    lens = [len(c) for c in cts]
    pad, nb, kpm, kpc, tail, lastadd, prevadd, nv = _siv_fused_prep(k1s, k2s, aads, lens, dev)
    bases = iv_arr.copy()
    bases[:, 8] &= 0x7F
    bases[:, 12] &= 0x7F
    blocks = _rows(_ragged_blocks(cts, nb), pad, dev)
    pt, s2v = siv_open_chain_fused(kpm, kpc, _rows(bases, pad, dev), torch.zeros_like(tail),
                                   blocks, nv, tail, lastadd, prevadd)
    return _verified(pt[:b].cpu().numpy(), lens, s2v[:b].cpu().numpy(), list(iv_arr), BLOCK)


@_regroup_mixed_keys(2)
def siv_encrypt_batch(keys: list[bytes], aads: list[bytes], pts: list[bytes], *,
                      device="cuda") -> list[tuple[bytes, bytes]]:
    """AES_SIV_encrypt (micro_aes.c:1372-1381) over B messages -> [(iv, ct)]:
    keys are K1 || K2 as in siv_encrypt; one K12 pass per key size (an
    all-empty batch needs only its S2V)."""
    dev = torch.device(device)
    k1s, k2s = _siv_split(keys)
    aads = [to_u8(a) for a in aads]
    pts = [to_u8(p) for p in pts]
    if max(len(p) for p in pts):
        return _siv_fused_seal_run(k1s, k2s, aads, pts, dev)
    ivs = _s2v_empty(stack_round_keys(k1s), aads, dev)
    return [(iv.tobytes(), b"") for iv in ivs]


@_regroup_mixed_keys(3)
def siv_decrypt_batch(keys: list[bytes], ivs: list[bytes], aads: list[bytes],
                      cts: list[bytes], *, device="cuda") -> list[bytes | None]:
    """Batched SIV open (micro_aes.c:1394-1410): decrypt, synthesize the IV
    again, compare; a message that fails comes back as None."""
    dev = torch.device(device)
    k1s, k2s = _siv_split(keys)
    aads = [to_u8(a) for a in aads]
    cts = [to_u8(c) for c in cts]
    iv_arr = np.stack([to_u8(iv)[:BLOCK] for iv in ivs])
    if max(len(c) for c in cts):
        return _siv_fused_open_run(k1s, k2s, iv_arr, aads, cts, dev)
    expects = _s2v_empty(stack_round_keys(k1s), aads, dev)
    return [b"" if verify_tag(expects[i], iv_arr[i]) else None for i in range(len(cts))]
