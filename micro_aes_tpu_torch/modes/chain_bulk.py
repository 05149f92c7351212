"""Multi-message batch engines of the serial-chain and basic modes.

CBC/CFB encrypt and the OFB keystream are loop-carried chains
(micro_aes.c:712-717, 808-814, 872-876): within one message they run
serially, so the parallelism is across messages.  Messages are grouped by
(block-count bucket, key size); each group's chains run in one launch of
K13 (ops/chain_kernels), lane-packed 32 messages per word with a key per
lane: the kernel on CUDA, its plain version on the CPU.  The parallel
directions (CBC/CFB decrypt, ECB, CTR) run as one K9 launch per group
(modes/bulk.cipher_blocks_multikey).  CTS splicing, padding and ragged
tails are host glue mirroring the per-message modules (cbc, cfb, ofb, ecb,
ctr), which the tests use as the oracle.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.bitslice import key_planes_packed
from ..errors import DataLengthError, DecryptionError
from ..ops.chain_kernels import chain_packed_fused, ofb_packed_fused
from ..ops.counter import ctr56_add
from ..utils.bytesio import BLOCK, block_bucket, to_blocks, to_u8, u32_tensor
from .bulk import cipher_blocks_multikey, cipher_blocks_multikey_dev, stack_round_keys
from .cbc import _cts_split
from .common import PAD_ZERO, pad_message
from .ctr import CTR_IV_LENGTH, CTR_START_VALUE


def _grouped(blocklists: list[np.ndarray], keys: list[bytes]):
    """Yield (idxs, rks uint8[B,R+1,16], padded blocks uint8[B,nb,16]), one
    group per (power-of-two block bucket, key size)."""
    groups: dict[tuple[int, int], list[int]] = {}
    for i, bl in enumerate(blocklists):
        groups.setdefault((block_bucket(len(bl)), len(keys[i])), []).append(i)
    for (nb, _), idxs in groups.items():
        rks = stack_round_keys([keys[i] for i in idxs])
        buf = np.zeros((len(idxs), nb, BLOCK), np.uint8)
        for k, i in enumerate(idxs):
            buf[k, : len(blocklists[i])] = blocklists[i]
        yield idxs, rks, buf


def _chain_group(kind: str, rks: np.ndarray, ivb: np.ndarray, buf: np.ndarray,
                 device) -> np.ndarray:
    """One group's serial chains through K13 on `device` (padded to a
    multiple of 32 messages with the last key, zero ivs and blocks) -> host
    uint8[B,nb,16].  For OFB only buf's shape counts (keystream only)."""
    b = rks.shape[0]
    pad = (-b) % 32
    if pad:
        rks = np.concatenate([rks, np.repeat(rks[-1:], pad, axis=0)])
        ivb = np.concatenate([ivb, np.zeros((pad, BLOCK), np.uint8)])
    kpw = u32_tensor(key_planes_packed(rks), device)
    ivs = torch.from_numpy(ivb).to(device)
    if kind == "ofb":
        return ofb_packed_fused(kpw, ivs, buf.shape[1])[:b].cpu().numpy()
    x = torch.zeros((b + pad,) + buf.shape[1:], dtype=torch.uint8, device=ivs.device)
    x[:b] = torch.from_numpy(buf)
    return chain_packed_fused(kind, kpw, ivs, x)[:b].cpu().numpy()


def _ivs(ivs) -> list[np.ndarray]:
    return [to_u8(iv)[:BLOCK] for iv in ivs]


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
    for idxs, rks, buf in _grouped(chains, keys):
        ys = _chain_group("cbc", rks, np.stack([iv_arr[i] for i in idxs]), buf, device)
        for k, i in enumerate(idxs):
            n, r = meta[i]
            c = ys[k]
            if r:  # CS3 swap (micro_aes.c:718-732)
                out[i] = bytes(np.concatenate([c[: n - 1].reshape(-1), c[n], c[n - 1][:r]]))
            else:
                out[i] = bytes(c[:n].reshape(-1))
    return out


def cbc_decrypt_batch(keys, ivs, cts_in, cts: bool = True, *, device="cuda") -> list[bytes]:
    """AES_CBC_decrypt over B messages: block-parallel, one K9 decrypt per
    group; a CTS tail adds a one-block decrypt of the spliced Y blocks
    (micro_aes.c:753-778)."""
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
    for idxs, _, buf in _grouped(blocklists, keys):
        dec = cipher_blocks_multikey([keys[i] for i in idxs], buf, True, device=device)
        for k, i in enumerate(idxs):
            n, r = meta[i]
            blocks = blocklists[i]
            if r == 0:
                prev = np.concatenate([iv_arr[i][None, :], blocks[:-1]])
                out[i] = bytes((dec[k, :n] ^ prev).reshape(-1))
                continue
            # CTS: head (m whole blocks), X (whole), Z (r bytes)
            m = n - 1
            dx = dec[k, m]
            z = datas[i][n * BLOCK:]
            y = dx.copy()
            y[:r] = z
            prevs = np.concatenate([iv_arr[i][None, :], blocks[: m - 1]]) if m else None
            out[i] = bytes((dec[k, :m] ^ prevs).reshape(-1)) if m else b""
            pending.append((i, y, blocks[m - 1] if m else iv_arr[i], dx[:r] ^ z))
    if pending:
        ys = np.stack([y for _, y, _, _ in pending])[:, None, :]
        dy = cipher_blocks_multikey([keys[i] for i, *_ in pending], ys, True,
                                    device=device)[:, 0]
        for k, (i, _, prev, tail) in enumerate(pending):
            out[i] += bytes(dy[k] ^ prev) + bytes(tail)
    return out


# CFB, micro_aes.c:789-846


def cfb_encrypt_batch(keys, ivs, pts, *, device="cuda") -> list[bytes]:
    """CFB encrypt chains over the zero-padded messages: the last step of a
    ragged message is E(y_last) ^ (tail || 0), whose first bytes are the
    tail's ciphertext."""
    keys, iv_arr = [bytes(k) for k in keys], _ivs(ivs)
    datas = [to_u8(p) for p in pts]
    out: list = [None] * len(datas)
    for idxs, rks, buf in _grouped([to_blocks(d) for d in datas], keys):
        ys = _chain_group("cfb", rks, np.stack([iv_arr[i] for i in idxs]), buf, device)
        for k, i in enumerate(idxs):
            out[i] = bytes(ys[k].reshape(-1)[: len(datas[i])])
    return out


def cfb_decrypt_batch(keys, ivs, cts_in, *, device="cuda") -> list[bytes]:
    """CFB decrypt is parallel: the keystream blocks are E([iv, C_0, ..]),
    one K9 launch per group (micro_aes.c:799-817, mode=0)."""
    keys, iv_arr = [bytes(k) for k in keys], _ivs(ivs)
    datas = [to_u8(c) for c in cts_in]
    ins = []
    for i, d in enumerate(datas):
        nin = -(-len(d) // BLOCK)
        blocks = np.zeros((max(nin, 1), BLOCK), np.uint8)
        blocks[0] = iv_arr[i]
        blocks[1:nin] = d[: (nin - 1) * BLOCK].reshape(-1, BLOCK)
        ins.append(blocks)
    out: list = [None] * len(datas)
    for idxs, _, buf in _grouped(ins, keys):
        ks = cipher_blocks_multikey([keys[i] for i in idxs], buf, device=device)
        for k, i in enumerate(idxs):
            d = datas[i]
            out[i] = bytes(ks[k].reshape(-1)[: len(d)] ^ d)
    return out


# OFB, micro_aes.c:852-893 (decrypt == encrypt)


def ofb_xcrypt_batch(keys, ivs, datas_in, *, device="cuda") -> list[bytes]:
    keys, iv_arr = [bytes(k) for k in keys], _ivs(ivs)
    datas = [to_u8(p) for p in datas_in]
    out: list = [None] * len(datas)
    for idxs, rks, buf in _grouped([to_blocks(d) for d in datas], keys):
        ks = _chain_group("ofb", rks, np.stack([iv_arr[i] for i in idxs]), buf, device)
        for k, i in enumerate(idxs):
            d = datas[i]
            out[i] = bytes(ks[k].reshape(-1)[: len(d)] ^ d)
    return out


ofb_encrypt_batch = ofb_xcrypt_batch
ofb_decrypt_batch = ofb_xcrypt_batch


# ECB, micro_aes.c:628-681


def ecb_encrypt_batch(keys, pts, padding: int = PAD_ZERO, *, device="cuda") -> list[bytes]:
    keys = [bytes(k) for k in keys]
    blocklists = [pad_message(to_u8(p), padding)[0].reshape(-1, BLOCK) for p in pts]
    out: list = [None] * len(pts)
    for idxs, _, buf in _grouped(blocklists, keys):
        enc = cipher_blocks_multikey([keys[i] for i in idxs], buf, device=device)
        for k, i in enumerate(idxs):
            out[i] = bytes(enc[k, : len(blocklists[i])].reshape(-1))
    return out


def ecb_decrypt_batch(keys, cts_in, *, device="cuda") -> list[bytes]:
    keys = [bytes(k) for k in keys]
    datas = [to_u8(c) for c in cts_in]
    if any(len(d) % BLOCK for d in datas):
        raise DecryptionError("ciphertext has a partial block")
    blocklists = [d.reshape(-1, BLOCK) for d in datas]
    out: list = [None] * len(datas)
    for idxs, _, buf in _grouped(blocklists, keys):
        dec = cipher_blocks_multikey([keys[i] for i in idxs], buf, True, device=device)
        for k, i in enumerate(idxs):
            out[i] = bytes(dec[k, : len(blocklists[i])].reshape(-1))
    return out


# CTR, micro_aes.c:953-991 (parallel both ways)


def ctr_xcrypt_batch(keys, ivs, datas_in, preset_counter: bool = False, *,
                     device="cuda") -> list[bytes]:
    """AES-CTR over B messages: the counter blocks of each group made on
    the device, one K9 launch per group."""
    keys = [bytes(k) for k in keys]
    datas = [to_u8(p) for p in datas_in]
    bases = np.zeros((len(datas), BLOCK), np.uint8)
    for i, iv in enumerate(ivs):
        if preset_counter:
            bases[i] = to_u8(iv)[:BLOCK]
        else:
            bases[i, :CTR_IV_LENGTH] = to_u8(iv)[:CTR_IV_LENGTH]
            bases[i, BLOCK - 1] ^= CTR_START_VALUE
    out: list = [None] * len(datas)
    for idxs, _, buf in _grouped([to_blocks(d) for d in datas], keys):
        steps = torch.arange(buf.shape[1], dtype=torch.int64, device=device)
        base = torch.from_numpy(bases[idxs]).to(device)
        ks = cipher_blocks_multikey_dev([keys[i] for i in idxs],
                                        ctr56_add(base[:, None, :], steps)).cpu().numpy()
        for k, i in enumerate(idxs):
            d = datas[i]
            out[i] = bytes(ks[k].reshape(-1)[: len(d)] ^ d)
    return out


ctr_encrypt_batch = ctr_xcrypt_batch
ctr_decrypt_batch = ctr_xcrypt_batch
