"""Ragged batch AES-GCM: B independent (key, nonce, AAD, message) tuples in
a fixed number of device calls, whatever B, with mixed key sizes (split
into one sub-batch per size), any nonce length and any message length.
The general fallback of the multi-key batch engine (modes/seal_batch), and
the GCM part of the JAX package's modes/bulk.py.

On the requested device: the keystreams of all messages (E(J0) riding in
front) go through K9 (ops/multikey.ctrw_fused_multikey), one launch per key
size; H = E_K(0) per key and the GHASH folds (ops/mac.ghash_fold_batch,
a loop over the longest AAD + message on the device) are plain PyTorch.
"""
from __future__ import annotations

import functools
import inspect

import numpy as np
import torch

from ..core.bitslice import key_planes_batch
from ..core.cipher import encrypt_blocks
from ..core.keyschedule import expand_keys_batch
from ..ops.counter import ctr56_add
from ..ops.mac import ghash_fold_batch
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


def cipher_blocks_multikey(keys: list, blocks: torch.Tensor) -> torch.Tensor:
    """E_k over uint8[B, nb, 16] with a key per row (keys of one size), on
    blocks' device, in one K9 launch.  Only the round keys cross to the
    device; their broadcast planes are built there."""
    b, nb = blocks.shape[0], blocks.shape[1]
    wm = mk_window_words(nb)
    words = blocks.contiguous().view(torch.int32).reshape(b, nb * 4)
    ctr = torch.nn.functional.pad(words, (0, wm * 128 - nb * 4)).reshape(b * wm, 128)
    rks = torch.from_numpy(stack_round_keys(keys)).to(blocks.device)
    kp_stack = key_planes_batch(rks).reshape(-1, 1)
    out = ctrw_fused_multikey(kp_stack, ctr, torch.zeros_like(ctr), b)
    o = out.reshape(b, wm * 128)[:, : nb * 4].contiguous()
    return o.view(torch.uint8).reshape(b, nb, BLOCK)


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
    ks_all = cipher_blocks_multikey(keys, ctr56_add(j0[:, None, :], steps))
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
