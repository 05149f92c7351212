"""K9: the multi-key block cipher, one key per message, in one launch.

Two entries of one kernel (csrc/multikey.cu), each on round-key bytes:

  cipher_blocks_ragged(rks, desc, blocks, decrypt=False)
      E_k (D_k) of a whole ragged batch: every message's blocks packed back
      to back (no bucket padding) in blocks uint8[N, 16], and a descriptor
      per row of 32 blocks (multikey_layout): where the row's round keys
      start in rks uint8[K, 16], its rounds, its first block and its valid
      blocks.  Rows are sorted by rounds, each rounds group padded to whole
      warps, so a call takes any mix of lengths and key sizes.  The batch
      engines (modes/bulk, modes/chain_bulk) run every K9 call through it.
  ctrw_multikey_rks(rks, ctr_words, pt_words, b, decrypt=False)
      The uniform cipher-and-xor: for B messages of Wm stream rows each
      (rows concatenated message after message), out = pt ^ E_k(ctr) (or
      D_k(ctr)) under message i's round keys rks[i] (uint8[B, R+1, 16]) for
      rows i*Wm .. (i+1)*Wm-1.  The stream is the w-major layout of
      ops/seal_kernels: row w holds blocks 32w..32w+31, lane 4j+k =
      little-endian word k of block 32w+j, that is bytes 512w..512w+511 of
      the blocks; the kernel computes its descriptors from (B, Wm).

`ctrw_fused_multikey(kp_stack, ctr_words, pt_words, b)` keeps the JAX
package's contract (stacked broadcast key planes) and reads the round keys
back out of the planes for the uniform entry; no batch path builds planes.

Each wrapper dispatches on the device of its data: on CUDA it launches the
kernel or raises; on the CPU it runs the plain PyTorch version
(`ctrw_fused_multikey_plain`, which follows the JAX package's
ctrw_fused_multikey_jnp, and `cipher_blocks_ragged_plain`, built from it
per rounds group).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.bitslice import (
    decrypt_planes,
    encrypt_planes,
    key_planes_batch,
    planes_to_words,
    words_to_planes,
)
from ..utils.keycache import key_cache
from . import _build
from .ragged import MAX_ROUNDS, desc_array, round_keys15
from .seal_kernels import _device, _kwords_to_stream, _stream_to_kwords

# The JAX package's Pallas row tile (pallas_seal.SEAL_TILE_W): the window
# contract below pads to it so that both packages cut the same windows.
_TILE_W = 256

_WORD_DTYPES = (torch.int32, torch.uint32)
_KROWS = MAX_ROUNDS + 1  # round-key rows per message in layout_round_keys


def mk_window_words(nblocks: int) -> int:
    """Stream rows per message window for a message of nblocks blocks:
    ceil(nblocks/32) padded to a multiple of 8, and further (by at most 56
    rows) until a row tile of at least 64 divides it.  The window of the
    JAX contract (ctrw_fused_multikey), shared with chip_smoke.py."""
    wm = -(-nblocks // 32)
    wm += (-wm) % 8
    while wm >= 64 and mk_tile(wm) < 64:
        wm += 8
    return wm


def mk_tile(wm: int) -> int:
    """Largest multiple of 8 up to _TILE_W that divides wm."""
    best = 8
    for t in range(8, min(wm, _TILE_W) + 1, 8):
        if wm % t == 0:
            best = t
    return best


# -- the ragged batch ---------------------------------------------------------

@dataclass(frozen=True)
class MkLayout:
    offsets: np.ndarray  # int64[M]: first block of message i (batch order) in the buffer
    desc: np.ndarray     # int32[W, 4]: (krow, rounds, first, valid) per row, W % 32 == 0
    nblocks: int         # blocks in the buffer


def multikey_layout(keys: list[bytes], nblocks) -> MkLayout:
    """The rows of a batch whose messages' blocks lie back to back in batch
    order (message i has nblocks[i] blocks; its round keys are rows 15i ..
    of layout_round_keys).  Rows of 32 blocks, a message's last one partial;
    sorted by rounds, AES-256 first, each rounds group padded to whole warps
    with idle rows (valid 0) under its last message's key."""
    nb = np.asarray(nblocks, np.int64).reshape(-1)
    if len(nb) != len(keys):
        raise ValueError(f"multikey_layout: {len(keys)} keys for {len(nb)} messages")
    if (nb < 0).any() or nb.sum() >= 2**31:
        raise ValueError("multikey_layout: block counts must be >= 0 and sum below 2**31")
    rounds = np.array([len(k) // 4 + 6 for k in keys], np.int64)
    offsets = np.zeros(len(nb), np.int64)
    offsets[1:] = np.cumsum(nb)[:-1]
    nrows = -(-nb // 32)
    parts = []
    for r in sorted({int(x) for x in rounds[nrows > 0]}, reverse=True):
        idx = np.flatnonzero((rounds == r) & (nrows > 0))
        msg = np.repeat(idx, nrows[idx])
        k = np.arange(len(msg)) - np.repeat(np.cumsum(nrows[idx]) - nrows[idx], nrows[idx])
        rows = np.stack([_KROWS * msg, np.full(len(msg), r), offsets[msg] + 32 * k,
                         np.minimum(32, nb[msg] - 32 * k)], 1)
        pad = (-len(rows)) % 32
        parts += [rows, np.tile([_KROWS * msg[-1], r, 0, 0], (pad, 1))]
    desc = np.concatenate(parts) if parts else np.zeros((0, 4), np.int64)
    return MkLayout(offsets, desc.astype(np.int32), int(nb.sum()))


@key_cache(maxsize=64)
def _rks_cached(blob: bytes, klens: bytes, device: torch.device) -> torch.Tensor:
    ends = np.cumsum(np.frombuffer(klens, np.uint8)).tolist()
    keys = [blob[e - n:e] for e, n in zip(ends, klens)]
    return torch.from_numpy(round_keys15(keys).reshape(-1, 16)).to(device)


def layout_round_keys(keys: list[bytes], device) -> torch.Tensor:
    """uint8[15M, 16] on `device`: message i's round keys at rows 15i ..
    (zero after its last round), cached per key sequence (a warm batch
    skips the expansion and the copy)."""
    keys = [bytes(k) for k in keys]
    return _rks_cached(b"".join(keys), bytes(len(k) for k in keys), torch.device(device))


def _check_ragged(desc: np.ndarray, krows: int, nblocks: int) -> None:
    """Raise ValueError unless every row's keys and blocks lie inside their
    buffers and each warp's rows share their rounds (the kernel skips such
    rows; the plain version needs them whole)."""
    if desc.ndim != 2 or desc.shape[1] != 4 or desc.shape[0] % 32:
        raise ValueError(f"cipher_blocks_ragged: desc shape {desc.shape}, expected [W, 4], "
                         "W % 32 == 0")
    krow, rounds, first, valid = desc.T
    warps = rounds.reshape(-1, 32)
    if ((rounds != 10) & (rounds != 12) & (rounds != 14)).any() or (warps != warps[:, :1]).any():
        raise ValueError("cipher_blocks_ragged: a row has bad rounds, or a warp mixed rounds")
    outside = (first < 0) | (first > nblocks - valid)
    if (krow < 0).any() or (krow + rounds >= krows).any() or (valid < 0).any() \
            or (valid > 32).any() or ((valid > 0) & outside).any():
        raise ValueError("cipher_blocks_ragged: a row points outside its buffers")


def cipher_blocks_ragged_plain(rks, desc, blocks, decrypt: bool = False):
    """Plain PyTorch version of cipher_blocks_ragged (same contract): the
    rows of each rounds group through ctrw_fused_multikey_plain, a row per
    message of one stream row, the valid blocks kept."""
    d = desc_array(desc)
    dev = blocks.device
    out = torch.zeros_like(blocks)
    j = np.arange(32)
    for rounds in sorted({int(x) for x in d[d[:, 3] > 0, 1]}):
        rows = d[(d[:, 1] == rounds) & (d[:, 3] > 0)]
        inside = j[None, :] < rows[:, 3:4]                           # [n, 32]
        idx = torch.from_numpy(np.where(inside, rows[:, 2:3] + j[None, :], 0)).to(dev)
        inside_t = torch.from_numpy(inside).to(dev)
        x = blocks[idx] * inside_t[..., None]                       # [n, 32, 16]
        krow = torch.from_numpy(rows[:, :1] + np.arange(rounds + 1)[None, :]).to(rks.device)
        kp = key_planes_batch(rks[krow]).reshape(-1, 1)
        words = x.reshape(len(rows), 512).view(torch.int32).reshape(len(rows), 128)
        y = ctrw_fused_multikey_plain(kp, words, torch.zeros_like(words), len(rows), decrypt)
        out[idx[inside_t]] = y.view(torch.uint8).reshape(len(rows), 32, 16)[inside_t]
    return out


def cipher_blocks_ragged(rks, desc, blocks, decrypt: bool = False):
    """K9's ragged entry: rks uint8[K, 16] round-key rows, desc int32[W, 4]
    (multikey_layout's, a host array, or that array already on the blocks'
    CUDA device), blocks uint8[N, 16] -> uint8[N, 16], E_k (D_k when
    decrypt) of every valid block of every row; blocks no row covers come
    back as zeros on the CPU and undefined on CUDA.  A host descriptor is
    checked (ValueError); on the card the kernel skips any row that points
    outside rks or the blocks."""
    if blocks.dim() != 2 or blocks.shape[1] != 16 or blocks.dtype != torch.uint8:
        raise ValueError(f"cipher_blocks_ragged: blocks {blocks.dtype} {tuple(blocks.shape)}")
    if rks.dim() != 2 or rks.shape[1] != 16 or rks.dtype != torch.uint8:
        raise ValueError(f"cipher_blocks_ragged: rks {rks.dtype} {tuple(rks.shape)}")
    on_card = torch.is_tensor(desc) and desc.device.type == "cuda"
    if on_card:
        if desc.dtype != torch.int32 or desc.dim() != 2 or desc.shape[1] != 4 \
                or desc.shape[0] % 32 or not desc.is_contiguous():
            raise ValueError(f"cipher_blocks_ragged: desc {desc.dtype} {tuple(desc.shape)}")
    else:
        desc = (desc.numpy() if torch.is_tensor(desc) else np.asarray(desc)).astype(np.int32,
                                                                                  copy=False)
        _check_ragged(desc, rks.shape[0], blocks.shape[0])
    if _device("cipher_blocks_ragged", blocks).type == "cpu":
        return cipher_blocks_ragged_plain(rks, desc, blocks, decrypt)
    for arg, t in (("rks", rks), ("blocks", blocks), ("desc", desc)):
        if torch.is_tensor(t) and (t.device != blocks.device or not t.is_contiguous()):
            raise ValueError(f"cipher_blocks_ragged: {arg} must be contiguous on {blocks.device}")
    out = torch.empty_like(blocks)
    if desc.shape[0]:
        blocks = blocks if blocks.data_ptr() % 16 == 0 else blocks.clone()
        desc_t = desc if on_card else torch.from_numpy(desc).to(blocks.device)
        lib = _build.load()
        with torch.cuda.device(blocks.device):
            stream = torch.cuda.current_stream(blocks.device).cuda_stream
            err = lib.micro_aes_multikey_ragged(rks.data_ptr(), desc_t.data_ptr(),
                                                blocks.data_ptr(), out.data_ptr(), desc.shape[0],
                                                rks.shape[0], blocks.shape[0], int(decrypt),
                                                stream)
        _build.check_launch("cipher_blocks_ragged", err)
        cipher_blocks_ragged.launches += 1
    return out


cipher_blocks_ragged.launches = 0


# -- the uniform cipher-and-xor (the JAX contract) -----------------------------

def _rounds_of(kp_stack: torch.Tensor, b: int) -> int:
    rounds = kp_stack.shape[0] // (b * 128) - 1
    if kp_stack.shape != (b * (rounds + 1) * 128, 1) or rounds not in (10, 12, 14):
        raise ValueError(f"ctrw_fused_multikey: kp_stack shape {tuple(kp_stack.shape)} for b={b}")
    return rounds


def ctrw_fused_multikey_plain(kp_stack, ctr_words, pt_words, b: int,
                              decrypt: bool = False):
    """Plain PyTorch version of ctrw_fused_multikey (same contract)."""
    i32 = torch.int32
    rounds = _rounds_of(kp_stack, b)
    wm = pt_words.shape[0] // b
    kp = kp_stack.view(i32).reshape(b, rounds + 1, 8, 16)
    kpw = kp.permute(1, 2, 3, 0).repeat_interleave(wm, dim=3)  # a key per row
    ctr = words_to_planes(_stream_to_kwords(ctr_words.view(i32)))
    ks = (decrypt_planes if decrypt else encrypt_planes)(kpw, ctr)
    out = _kwords_to_stream(planes_to_words(ks)) ^ pt_words.view(i32)
    return out.view(pt_words.dtype)


def _round_key_bytes(kp_stack: torch.Tensor, b: int, rounds: int) -> torch.Tensor:
    """kp_stack (0/-1 plane words) -> the round-key stack uint8[B,R+1,16]
    it encodes: byte p of round r = sum_b bit(plane (r, b, p)) << b."""
    bits = kp_stack.view(torch.int32).reshape(b, rounds + 1, 8, 16) & 1
    shifts = torch.arange(8, dtype=torch.int32, device=kp_stack.device)[:, None]
    return (bits << shifts).sum(dim=2).to(torch.uint8)


def _check_streams(name, rows_dev, ctr_words, pt_words, b):
    for arg, t in (("ctr_words", ctr_words), ("pt_words", pt_words)):
        if t.device != rows_dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {rows_dev}")
        if t.dtype not in _WORD_DTYPES:
            raise TypeError(f"{name}: {arg} must be int32 or uint32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    rows = pt_words.shape[0]
    if b <= 0 or rows % b or pt_words.shape != (rows, 128) or ctr_words.shape != (rows, 128):
        raise ValueError(f"{name}: streams {tuple(ctr_words.shape)}, {tuple(pt_words.shape)} "
                         f"for b={b}")
    if ctr_words.data_ptr() % 16 or pt_words.data_ptr() % 16:
        raise ValueError(f"{name}: streams must be 16-byte aligned")


def ctrw_multikey_rks(rks, ctr_words, pt_words, b: int, decrypt: bool = False):
    """K9's uniform entry on round-key bytes: rks uint8[B, R+1, 16],
    ctr_words and pt_words [B*Wm, 128] int32 or uint32 streams ->
    [B*Wm, 128]: pt ^ E_k(ctr) per message (D_k when decrypt)."""
    if rks.dim() != 3 or rks.shape[0] != b or rks.shape[2] != 16 or rks.dtype != torch.uint8 \
            or rks.shape[1] - 1 not in (10, 12, 14):
        raise ValueError(f"ctrw_multikey_rks: rks {rks.dtype} {tuple(rks.shape)} for b={b}")
    if _device("ctrw_multikey_rks", pt_words).type == "cpu":
        return ctrw_fused_multikey_plain(key_planes_batch(rks).reshape(-1, 1), ctr_words,
                                         pt_words, b, decrypt)
    _check_streams("ctrw_multikey_rks", pt_words.device, ctr_words, pt_words, b)
    if rks.device != pt_words.device or not rks.is_contiguous():
        raise ValueError(f"ctrw_multikey_rks: rks must be contiguous on {pt_words.device}")
    out = torch.empty_like(pt_words)
    rows = pt_words.shape[0]
    if rows:
        lib = _build.load()
        with torch.cuda.device(pt_words.device):
            stream = torch.cuda.current_stream(pt_words.device).cuda_stream
            err = lib.micro_aes_multikey(rks.data_ptr(), ctr_words.data_ptr(),
                                         pt_words.data_ptr(), out.data_ptr(), rks.shape[1] - 1,
                                         rows // b, rows, int(decrypt), stream)
        _build.check_launch("ctrw_multikey_rks", err)
        ctrw_multikey_rks.launches += 1
    return out


ctrw_multikey_rks.launches = 0


def ctrw_fused_multikey(kp_stack, ctr_words, pt_words, b: int,
                        decrypt: bool = False):
    """The JAX contract: kp_stack [B*(R+1)*128, 1] (B stacked key_planes,
    core/bitslice), ctr_words and pt_words [B*Wm, 128] int32 or uint32
    streams -> [B*Wm, 128]: pt ^ E_k(ctr) per message (D_k when decrypt);
    on CUDA the uniform entry on the round keys the planes encode."""
    if _device("ctrw_fused_multikey", pt_words).type == "cpu":
        return ctrw_fused_multikey_plain(kp_stack, ctr_words, pt_words, b, decrypt)
    if kp_stack.device != pt_words.device or kp_stack.dtype not in _WORD_DTYPES:
        raise ValueError(f"ctrw_fused_multikey: kp_stack {kp_stack.dtype} on {kp_stack.device}")
    rounds = _rounds_of(kp_stack, b)
    return ctrw_multikey_rks(_round_key_bytes(kp_stack, b, rounds), ctr_words, pt_words, b,
                             decrypt)
