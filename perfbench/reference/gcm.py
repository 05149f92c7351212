"""Plain AES-GCM (NIST SP 800-38D) in PyTorch: many messages, a key each.

96-bit IVs only (J0 = IV || 0^31 || 1), the only form the benchmark's
configurations use.  GHASH multiplies by H through 8-bit tables made per
key from the 128 products H * x^i, and folds every message's blocks in one
loop over the longest message, one step for all messages at once.  Open
computes and checks the tag before it releases a message (§7.2): a message
whose tag differs comes back as None.
"""
from __future__ import annotations

import numpy as np
import torch

from . import aes

BLOCK = aes.BLOCK


def _times_x(v: torch.Tensor) -> torch.Tensor:
    """v * x in GCM's bit order (bit 0 is the top bit of byte 0): a right
    shift across the 16 bytes, reduced by R = 0xE1 || 0^120."""
    carry = torch.cat([torch.zeros_like(v[..., :1]), v[..., :-1] & 1], -1)
    out = (v >> 1) | (carry << 7)
    out[..., 0] ^= (v[..., 15] & 1) * 0xE1
    return out


def mul_tables(h: torch.Tensor) -> torch.Tensor:
    """uint8[B, 16] keys' H -> uint8[B, 16, 256, 16]: entry [p, b] is the
    product of H with the element whose only non-zero byte is b at p."""
    basis = [h]
    for _ in range(127):
        basis.append(_times_x(basis[-1]))
    basis = torch.stack(basis, 1)  # [B, 128, 16]: H * x^i
    vals = torch.arange(256, device=h.device)
    out = torch.zeros((h.shape[0], 16, 256, 16), dtype=torch.uint8, device=h.device)
    for j in range(8):  # bit j of the byte, from the top: x^(8p + j)
        bit = ((vals >> (7 - j)) & 1).to(torch.uint8)[None, None, :, None]
        out ^= bit * basis[:, j::8, None, :]
    return out


def _mul(tab: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x * H for uint8[B, 16] x and its tables uint8[B, 16, 256, 16]."""
    b = x.shape[0]
    rows = tab.reshape(b * 16 * 256, 16)
    idx = (torch.arange(b * 16, device=x.device).reshape(b, 16) * 256) + x.long()
    parts = rows[idx.reshape(-1)].view(torch.int64).reshape(b, 16, 2)
    for half in (8, 4, 2, 1):  # XOR of the 16 partial products, as 64-bit words
        parts = parts[:, :half] ^ parts[:, half:2 * half]
    return parts.reshape(b, 2).view(torch.uint8)


def ghash(tab: torch.Tensor, blocks: torch.Tensor, nvalid: torch.Tensor) -> torch.Tensor:
    """GHASH of each message's first nvalid[i] blocks of uint8[B, M, 16]."""
    y = torch.zeros_like(blocks[:, 0])
    for i in range(blocks.shape[1]):
        step = _mul(tab, y ^ blocks[:, i])
        y = torch.where((i < nvalid)[:, None], step, y)
    return y


def _pad_rows(datas, nblocks: int) -> np.ndarray:
    out = np.zeros((len(datas), nblocks * BLOCK), np.uint8)
    for i, d in enumerate(datas):
        out[i, : len(d)] = np.frombuffer(bytes(d), np.uint8)
    return out


def _counter_blocks(j0: torch.Tensor, count: int) -> torch.Tensor:
    """inc32(J0) .. inc32^count(J0): uint8[B, count, 16]."""
    low = j0[:, 12:].long()
    c = (low[:, 0] << 24) | (low[:, 1] << 16) | (low[:, 2] << 8) | low[:, 3]
    steps = torch.arange(1, count + 1, device=j0.device)
    ctr = (c[:, None] + steps[None, :]) & 0xFFFFFFFF
    out = j0[:, None, :].repeat(1, count, 1)
    for k in range(4):
        out[:, :, 12 + k] = ((ctr >> (24 - 8 * k)) & 0xFF).to(torch.uint8)
    return out


def _core(keys, nonces, aads, datas, decrypt: bool, device):
    """(outputs uint8[B, nb*16], tags uint8[B, 16]) of GCM over `datas`,
    read as plaintext (seal) or ciphertext (open)."""
    b = len(keys)
    if any(len(n) != 12 for n in nonces):
        raise ValueError("the reference takes 96-bit IVs only")
    rk = aes.round_keys(keys, device)[:, None]  # [B, 1, R+1, 16]
    h = aes.encrypt(rk[:, 0], torch.zeros((b, BLOCK), dtype=torch.uint8, device=device))
    j0 = torch.zeros((b, BLOCK), dtype=torch.uint8, device=device)
    j0[:, :12] = torch.from_numpy(_pad_rows(nonces, 1)[:, :12]).to(device)
    j0[:, 15] = 1
    lens = [len(d) for d in datas]
    nb = max(-(-n // BLOCK) for n in lens)
    data = torch.from_numpy(_pad_rows(datas, max(nb, 1))).to(device)
    ks = aes.encrypt(rk, _counter_blocks(j0, max(nb, 1))).reshape(b, -1)
    mask = (torch.arange(data.shape[1], device=device)[None, :]
            < torch.tensor(lens, device=device)[:, None])
    out = torch.where(mask, data ^ ks, 0)
    ct = data if decrypt else out
    # GHASH input per message: A || 0-pad || C || 0-pad || len(A) || len(C)
    na = [-(-len(a) // BLOCK) for a in aads]
    nc = [-(-n // BLOCK) for n in lens]
    width = max(x + y for x, y in zip(na, nc)) + 1
    ct_np = ct.reshape(b, -1, BLOCK).cpu().numpy()
    gin_np = np.zeros((b, width, BLOCK), np.uint8)
    for i in range(b):
        gin_np[i, : na[i]] = _pad_rows([aads[i]], max(na[i], 1))[0].reshape(-1, BLOCK)[: na[i]]
        gin_np[i, na[i]: na[i] + nc[i]] = ct_np[i, : nc[i]]
        gin_np[i, na[i] + nc[i], :8] = np.frombuffer((8 * len(aads[i])).to_bytes(8, "big"), np.uint8)
        gin_np[i, na[i] + nc[i], 8:] = np.frombuffer((8 * lens[i]).to_bytes(8, "big"), np.uint8)
    gin = torch.from_numpy(gin_np).to(device)
    nvalid = torch.tensor([x + y + 1 for x, y in zip(na, nc)], device=device)
    s = ghash(mul_tables(h), gin, nvalid)
    tags = aes.encrypt(rk[:, 0], j0) ^ s
    return out.cpu().numpy(), tags.cpu().numpy(), lens


def seal(keys, nonces, aads, pts, *, device="cpu") -> list[bytes]:
    """ct || tag (16 bytes) of each message."""
    out, tags, lens = _core(keys, nonces, aads, pts, False, device)
    return [out[i, :n].tobytes() + tags[i].tobytes() for i, n in enumerate(lens)]


def open_(keys, nonces, aads, ct_tags, *, device="cpu") -> list[bytes | None]:
    """The plaintext of each message whose 16-byte tag verifies, else None."""
    cts = [bytes(c)[:-BLOCK] for c in ct_tags]
    out, tags, lens = _core(keys, nonces, aads, cts, True, device)
    return [out[i, :n].tobytes() if tags[i].tobytes() == bytes(c)[-BLOCK:] else None
            for i, (n, c) in enumerate(zip(lens, ct_tags))]
