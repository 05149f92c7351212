"""The word layout of the ragged lane-spread kernels: K13's
chain_packed_ragged (ops/chain_kernels) and K16's kw_wheel_ragged
(ops/kw_kernels) run a whole batch of messages of different lengths and key
sizes in one launch.

A word holds 32 message slots that run in lockstep, so its messages share
their step count (K13: blocks, K16: semiblocks n) and their rounds; a warp
holds two words, which must share both too (the kernels' shuffles need the
whole warp, and no loop count may differ within it).  ragged_layout sorts the
messages by (steps, rounds), longest first, packs each run of equal (steps,
rounds) 32 to a word and gives a run with an odd number of words an idle
word (live 0).  Blocks start in that order, so a launch lasts about as long
as its longest word.  Each word's descriptor is int64[4] = (steps, rounds |
live << 8, msg0, off): slot j < live is the message at packed position
msg0 + j, and the message at packed position k has its row of row_bytes[k]
bytes at offsets[k] of the data buffer (rows packed in that order).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.keyschedule import expand_keys_batch
from ..utils.bytesio import i32_from_u32
from ..utils.keycache import key_cache

MAX_ROUNDS = 14


@dataclass(frozen=True)
class Layout:
    order: np.ndarray    # int64[M]: batch index of the message at packed position k
    word: np.ndarray     # int64[M]: its word
    slot: np.ndarray     # int64[M]: its slot in the word
    offsets: np.ndarray  # int64[M]: byte offset of its row in the data buffer
    desc: np.ndarray     # int64[W, 4]: (steps, rounds | live << 8, msg0, off)
    nbytes: int          # size of the data buffer


def ragged_layout(steps, rounds, row_bytes) -> Layout:
    """The words of a batch: steps, rounds and row_bytes per message (batch
    order).  Messages with no step are left out (they have no output)."""
    steps = np.asarray(steps, np.int64)
    rounds = np.asarray(rounds, np.int64)
    rows = np.asarray(row_bytes, np.int64)
    keep = np.flatnonzero(steps > 0)
    order = keep[np.lexsort((keep, -rounds[keep], -steps[keep]))]
    offsets = np.zeros(len(order), np.int64)
    if len(order):
        offsets[1:] = np.cumsum(rows[order])[:-1]
    word = np.zeros(len(order), np.int64)
    slot = np.zeros(len(order), np.int64)
    s_o, r_o = steps[order], rounds[order]
    starts = np.flatnonzero(np.r_[len(order) > 0, (s_o[1:] != s_o[:-1]) | (r_o[1:] != r_o[:-1])])
    desc = []
    for k, end in zip(starts.tolist(), np.r_[starts[1:], len(order)].tolist()):  # the runs
        s, r = int(s_o[k]), int(r_o[k])
        for k0 in range(k, end, 32):
            live = min(32, end - k0)
            word[k0:k0 + live] = len(desc)
            slot[k0:k0 + live] = np.arange(live)
            desc.append((s, r | live << 8, k0, int(offsets[k0])))
        if len(desc) % 2:
            desc.append((s, r, 0, 0))  # the idle word of an odd run
    return Layout(order, word, slot, offsets, np.asarray(desc, np.int64).reshape(-1, 4),
                  int(rows[order].sum()))


def round_keys15(keys: list[bytes]) -> np.ndarray:
    """uint8[B, 15, 16]: each key's round keys, zero after its last round
    (keys of 16, 24 and 32 bytes mixed)."""
    out = np.zeros((len(keys), MAX_ROUNDS + 1, 16), np.uint8)
    for klen in {len(k) for k in keys}:
        idx = [i for i, k in enumerate(keys) if len(k) == klen]
        rks = expand_keys_batch(np.frombuffer(b"".join(keys[i] for i in idx), np.uint8)
                                .reshape(len(idx), klen))
        out[idx, :rks.shape[1]] = rks
    return out


def ragged_key_planes(rks15: np.ndarray, word: np.ndarray, slot: np.ndarray, w: int,
                      device) -> torch.Tensor:
    """int32[15, 8, 16, w] lane-packed key planes of w words
    (core/bitslice.key_planes_packed's layout: bit j of [r, b, p, v] = bit b
    of byte p of round key r of slot j of word v), from uint8[M, 15, 16]
    round keys whose message k sits in slot slot[k] of word word[k]; idle
    slots get zero planes.  Built on `device`."""
    m = rks15.shape[0]
    r = torch.from_numpy(np.ascontiguousarray(rks15)).to(device).to(torch.int64)
    shifts = torch.arange(8, dtype=torch.int64, device=r.device)
    bits = ((r[..., None] >> shifts) & 1).permute(0, 1, 3, 2).reshape(m, -1)  # [M, 15*8*16]
    bits = bits << torch.from_numpy(slot).to(r.device)[:, None]
    acc = torch.zeros((w, bits.shape[1]), dtype=torch.int64, device=r.device)
    acc.index_add_(0, torch.from_numpy(word).to(r.device), bits)
    return i32_from_u32(acc).T.reshape(MAX_ROUNDS + 1, 8, 16, w).contiguous()


@key_cache(maxsize=64)
def _planes_cached(blob: bytes, klens: bytes, word: bytes, slot: bytes, w: int,
                   device: torch.device) -> torch.Tensor:
    ends = np.cumsum(np.frombuffer(klens, np.uint8)).tolist()
    keys = [blob[e - n:e] for e, n in zip(ends, klens)]
    return ragged_key_planes(round_keys15(keys), np.frombuffer(word, np.int64).copy(),
                             np.frombuffer(slot, np.int64).copy(), w, device)


def layout_key_planes(keys: list[bytes], layout: Layout, device) -> torch.Tensor:
    """ragged_key_planes of a batch's keys (batch order) in `layout`'s words,
    cached per key sequence and layout (a warm batch skips the expansion)."""
    packed = [keys[i] for i in layout.order]
    return _planes_cached(b"".join(packed), bytes(len(k) for k in packed),
                          layout.word.tobytes(), layout.slot.tobytes(), layout.desc.shape[0],
                          torch.device(device))


def desc_array(desc) -> np.ndarray:
    """A descriptor table (host array or tensor) as a host int64 array."""
    return (desc.cpu().numpy() if torch.is_tensor(desc) else np.asarray(desc)).astype(np.int64)


def aligned(t: torch.Tensor | None, nbytes: int) -> torch.Tensor | None:
    """t, or a fresh copy when its first byte is not nbytes-aligned (the
    kernels move rows of nbytes)."""
    return t if t is None or t.data_ptr() % nbytes == 0 else t.clone()


def check_desc(name: str, desc: np.ndarray, nrows: int | None, nbytes: int, row_bytes) -> None:
    """Raise ValueError unless every word's slots lie inside the data buffer
    (nbytes) and the packed rows (nrows; None when msg0 is unused), rounds
    are an AES count, and the two words of each warp share steps and
    rounds.  row_bytes(steps) -> the bytes of one slot's row."""
    if desc.ndim != 2 or desc.shape[1] != 4 or desc.shape[0] % 2:
        raise ValueError(f"{name}: desc shape {desc.shape}, expected [W, 4] with W even")
    steps, rounds, live = desc[:, 0], desc[:, 1] & 0xFF, desc[:, 1] >> 8
    if not np.isin(rounds, (10, 12, 14)).all() or (live < 0).any() or (live > 32).any():
        raise ValueError(f"{name}: a descriptor has bad rounds or live count")
    if (steps[0::2] != steps[1::2]).any() or (rounds[0::2] != rounds[1::2]).any():
        raise ValueError(f"{name}: the two words of a warp differ in steps or rounds")
    on = live > 0
    ends = desc[on, 3] + live[on] * row_bytes(steps[on])
    if (steps[on] < 0).any() or (desc[on, 2] < 0).any() or (desc[on, 3] < 0).any() \
            or (nrows is not None and (desc[on, 2] + live[on] > nrows).any()) \
            or (ends > nbytes).any():
        raise ValueError(f"{name}: a descriptor points outside its buffers")
