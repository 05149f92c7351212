"""Multi-message batch engines of the serial-chain and basic modes.

CBC/CFB encrypt and the OFB keystream are loop-carried chains
(micro_aes.c:712-717, 808-814, 872-876): within one message they run
serially, so the parallelism is across messages.  A call's chains run in
one launch of K13 (ops/chain_kernels.chain_packed_ragged), the messages
sorted by (block count, key size) and lane-packed 32 to a word with a key
per lane (ops/ragged): the kernel on CUDA, its plain version on the CPU.
The parallel directions (CBC/CFB decrypt, ECB, CTR) run as one launch of
K9's ragged entry per call (modes/bulk.cipher_lists, ops/multikey), the
messages' blocks packed back to back, whatever the lengths and key sizes;
CBC-CTS decrypt takes a second launch for the blocks its stealing splices.
CTS splicing, padding and ragged tails are host glue mirroring the
per-message modules (cbc, cfb, ofb, ecb, ctr), which the tests use as the
oracle.
"""
from __future__ import annotations

import numpy as np
import torch

from ..errors import DataLengthError, DecryptionError
from ..ops.chain_kernels import chain_packed_ragged
from ..ops.counter import ctr56_add
from ..ops.ragged import layout_key_planes, ragged_layout
from ..utils.bytesio import BLOCK, to_blocks, to_u8
from .bulk import cipher_blocks_ragged_dev, cipher_lists
from .cbc import _cts_split
from .common import PAD_ZERO, iv_block, pad_message
from .ctr import CTR_IV_LENGTH, CTR_START_VALUE


def _chain_ragged(kind: str, keys: list[bytes], iv_arr: list[np.ndarray],
                  blocklists: list[np.ndarray], device) -> list[np.ndarray]:
    """The serial chains of a whole call in one K13 launch on `device` ->
    host uint8[nb, 16] per message, in batch order.  For OFB only each
    block list's length counts (keystream only)."""
    dev = torch.device(device)
    steps = [len(bl) for bl in blocklists]
    lay = ragged_layout(steps, [len(k) // 4 + 6 for k in keys], [BLOCK * n for n in steps])
    out = [np.zeros((n, BLOCK), np.uint8) for n in steps]
    if not len(lay.order):
        return out
    kpw = layout_key_planes(keys, lay, dev)
    ivs = torch.from_numpy(np.stack([iv_arr[i] for i in lay.order])).to(dev)
    if kind == "ofb":
        ys = chain_packed_ragged("ofb", kpw, lay.desc, ivs, nbytes=lay.nbytes)
    else:
        data = np.concatenate([blocklists[i].reshape(-1) for i in lay.order])
        ys = chain_packed_ragged(kind, kpw, lay.desc, ivs, torch.from_numpy(data).to(dev))
    ys = ys.cpu().numpy()
    for k, i in enumerate(lay.order):
        out[i] = ys[lay.offsets[k]:lay.offsets[k] + BLOCK * steps[i]].reshape(-1, BLOCK)
    return out


def _ivs(ivs) -> list[np.ndarray]:
    return [iv_block(iv) for iv in ivs]


# CBC (+CS3 ciphertext stealing), micro_aes.c:687-783


def cbc_encrypt_batch(keys, ivs, pts, cts: bool = True, padding: int = PAD_ZERO, *,
                      device="cuda") -> list[bytes]:
    """AES_CBC_encrypt over B messages.  The CTS stolen block is one more
    chain step (stolen = E(c_last ^ padded tail)), so it rides the same
    launch."""
    keys, iv_arr = [bytes(k) for k in keys], _ivs(ivs)
    datas = [to_u8(p) for p in pts]
    chains: list[np.ndarray] = []
    meta: list[tuple[int, int]] = []  # (whole chain blocks, tail bytes)
    for d in datas:
        if cts:
            n, r = _cts_split(len(d))
            blocks = np.zeros((n + (1 if r else 0), BLOCK), np.uint8)
            blocks.reshape(-1)[: len(d)] = d
        else:
            padded, _ = pad_message(d, padding)
            blocks, n, r = padded.reshape(-1, BLOCK), len(padded) // BLOCK, 0
        chains.append(blocks)
        meta.append((n, r))
    out: list = [None] * len(datas)
    for i, c in enumerate(_chain_ragged("cbc", keys, iv_arr, chains, device)):
        n, r = meta[i]
        if r:  # CS3 swap (micro_aes.c:718-732)
            out[i] = bytes(np.concatenate([c[: n - 1].reshape(-1), c[n], c[n - 1][:r]]))
        else:
            out[i] = bytes(c[:n].reshape(-1))
    return out


def cbc_decrypt_batch(keys, ivs, cts_in, cts: bool = True, *, device="cuda") -> list[bytes]:
    """AES_CBC_decrypt over B messages: block-parallel, one K9 decrypt of
    every message's blocks; CTS tails add one more launch, a one-block
    decrypt of each spliced Y block (micro_aes.c:753-778)."""
    keys, iv_arr = [bytes(k) for k in keys], _ivs(ivs)
    datas = [to_u8(c) for c in cts_in]
    blocklists, meta = [], []
    for d in datas:
        if cts:
            n, r = _cts_split(len(d))
        else:
            n, r = divmod(len(d), BLOCK)
            if r:
                raise DataLengthError("ciphertext must be a block multiple")
        blocklists.append(d[: n * BLOCK].reshape(n, BLOCK))
        meta.append((n, r))
    out: list = [None] * len(datas)
    pending = []  # (message, Y, the block before it, the plaintext tail)
    for i, dec in enumerate(cipher_lists(keys, blocklists, True, device=device)):
        n, r = meta[i]
        blocks = blocklists[i]
        if r == 0:
            prev = np.concatenate([iv_arr[i][None, :], blocks[:-1]])
            out[i] = bytes((dec[:n] ^ prev).reshape(-1))
            continue
        # CTS: head (m whole blocks), X (whole), Z (r bytes)
        m = n - 1
        dx = dec[m]
        z = datas[i][n * BLOCK:]
        y = dx.copy()
        y[:r] = z
        prevs = np.concatenate([iv_arr[i][None, :], blocks[: m - 1]]) if m else None
        out[i] = bytes((dec[:m] ^ prevs).reshape(-1)) if m else b""
        pending.append((i, y, blocks[m - 1] if m else iv_arr[i], dx[:r] ^ z))
    if pending:
        dy = cipher_lists([keys[i] for i, *_ in pending], [y[None, :] for _, y, _, _ in pending],
                          True, device=device)
        for k, (i, _, prev, tail) in enumerate(pending):
            out[i] += bytes(dy[k][0] ^ prev) + bytes(tail)
    return out


# CFB, micro_aes.c:789-846


def cfb_encrypt_batch(keys, ivs, pts, *, device="cuda") -> list[bytes]:
    """CFB encrypt chains over the zero-padded messages: the last step of a
    ragged message is E(y_last) ^ (tail || 0), whose first bytes are the
    tail's ciphertext."""
    keys, iv_arr = [bytes(k) for k in keys], _ivs(ivs)
    datas = [to_u8(p) for p in pts]
    ys = _chain_ragged("cfb", keys, iv_arr, [to_blocks(d) for d in datas], device)
    return [bytes(y.reshape(-1)[: len(d)]) for y, d in zip(ys, datas)]


def cfb_decrypt_batch(keys, ivs, cts_in, *, device="cuda") -> list[bytes]:
    """CFB decrypt is parallel: the keystream blocks are E([iv, C_0, ..]),
    one K9 launch for the batch (micro_aes.c:799-817, mode=0)."""
    keys, iv_arr = [bytes(k) for k in keys], _ivs(ivs)
    datas = [to_u8(c) for c in cts_in]
    ins = []
    for i, d in enumerate(datas):
        nin = -(-len(d) // BLOCK)
        blocks = np.zeros((max(nin, 1), BLOCK), np.uint8)
        blocks[0] = iv_arr[i]
        blocks[1:nin] = d[: (nin - 1) * BLOCK].reshape(-1, BLOCK)
        ins.append(blocks)
    ks = cipher_lists(keys, ins, device=device)
    return [bytes(k.reshape(-1)[: len(d)] ^ d) for k, d in zip(ks, datas)]


# OFB, micro_aes.c:852-893 (decrypt == encrypt)


def ofb_xcrypt_batch(keys, ivs, datas_in, *, device="cuda") -> list[bytes]:
    keys, iv_arr = [bytes(k) for k in keys], _ivs(ivs)
    datas = [to_u8(p) for p in datas_in]
    ks = _chain_ragged("ofb", keys, iv_arr, [to_blocks(d) for d in datas], device)
    return [bytes(k.reshape(-1)[: len(d)] ^ d) for k, d in zip(ks, datas)]


ofb_encrypt_batch = ofb_xcrypt_batch
ofb_decrypt_batch = ofb_xcrypt_batch


# ECB, micro_aes.c:628-681


def ecb_encrypt_batch(keys, pts, padding: int = PAD_ZERO, *, device="cuda") -> list[bytes]:
    keys = [bytes(k) for k in keys]
    blocklists = [pad_message(to_u8(p), padding)[0].reshape(-1, BLOCK) for p in pts]
    return [bytes(c.reshape(-1)) for c in cipher_lists(keys, blocklists, device=device)]


def ecb_decrypt_batch(keys, cts_in, *, device="cuda") -> list[bytes]:
    keys = [bytes(k) for k in keys]
    datas = [to_u8(c) for c in cts_in]
    if any(len(d) % BLOCK for d in datas):
        raise DecryptionError("ciphertext has a partial block")
    blocklists = [d.reshape(-1, BLOCK) for d in datas]
    return [bytes(p.reshape(-1)) for p in cipher_lists(keys, blocklists, True, device=device)]


# CTR, micro_aes.c:953-991 (parallel both ways)


def ctr_xcrypt_batch(keys, ivs, datas_in, preset_counter: bool = False, *,
                     device="cuda") -> list[bytes]:
    """AES-CTR over B messages: every message's counter blocks made on the
    device, packed back to back, and one K9 launch for the batch."""
    keys = [bytes(k) for k in keys]
    datas = [to_u8(p) for p in datas_in]
    bases = np.zeros((len(datas), BLOCK), np.uint8)
    for i, iv in enumerate(ivs):
        if preset_counter:
            bases[i] = to_u8(iv)[:BLOCK]
        else:
            bases[i, :CTR_IV_LENGTH] = to_u8(iv)[:CTR_IV_LENGTH]
            bases[i, BLOCK - 1] ^= CTR_START_VALUE
    nb = np.array([-(-len(d) // BLOCK) for d in datas], np.int64)
    if not nb.sum():
        return [b""] * len(datas)
    dev = torch.device(device)
    msg = np.repeat(np.arange(len(datas)), nb)
    steps = np.arange(len(msg)) - np.repeat(np.cumsum(nb) - nb, nb)
    ctrs = ctr56_add(torch.from_numpy(bases).to(dev)[torch.from_numpy(msg).to(dev)],
                     torch.from_numpy(steps).to(dev))
    ks = cipher_blocks_ragged_dev(keys, ctrs, nb).cpu().numpy()
    ks = np.split(ks.reshape(-1), BLOCK * np.cumsum(nb)[:-1])
    return [bytes(k[: len(d)] ^ d) for k, d in zip(ks, datas)]


ctr_encrypt_batch = ctr_xcrypt_batch
ctr_decrypt_batch = ctr_xcrypt_batch
