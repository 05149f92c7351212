"""Bulk AES-GCM-SIV seal/open (RFC 8452): the nonce-misuse-resistant AEAD
at bulk throughput, for a 12-byte nonce, a whole-block message and no AAD
(modes/gcm_siv serves everything else and is this engine's oracle).

  seal pass 1: POLYVAL of the message and the length block, level 1 in K4
               (ops/siv_kernels.ghash1_fused: GHASH's level-1 fold; only
               the per-(key, nonce) table differs), level 2 and combine as
               GF(2) products (ops/ghash_bulk) -> the tag;
  seal pass 2: CTR from the tag with LE32 counters built inside K5
               (siv_ctrw_fused);
  open:        ONE pass of K5-open (siv_open_fused): decrypt with the
               received tag and fold the level-1 POLYVAL of the recovered
               plaintext; the length block joins afterwards as one product
               by M_H, and the tag is checked before any plaintext leaves.

Both passes share one w-major stream with the message at the stream TAIL
and the length block at its last position: POLYVAL's exponents count from
the end, so all padding lands in front, where masked positions cost
nothing, and the counter base simply shifts by the front offset.

Every public entry point takes `device=` ("cuda" unless the caller asks
for the CPU).  The stream path runs on every device: the kernels on CUDA,
their plain versions on the CPU (the JAX package instead hands the CPU to
its per-message path).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.bitslice import key_planes
from ..core.keyschedule import expand_key
from ..errors import AuthenticationError
from ..ops.gf128 import bits_to_blocks, blocks_to_bits, polyval_matrix
from ..ops.ghash_bulk import _gf2_matmul_i8, fold_level1, ghash_power_tables
from ..ops.seal_kernels import SEAL_WORD_ALIGN
from ..ops.siv_kernels import ghash1_fused, siv_ctrw_fused, siv_open_fused
from ..utils.bytesio import BLOCK, i32_from_u32, u32_tensor, verify_tag
from ..utils.keycache import key_cache
from .gcm_siv import _derive_keys, _lengths_le, _nonce, siv_tag
from .seal import (
    _from_device_stream,
    _to_device_stream,
    _whole_blocks,
    host_stream,
    key_setup_from_jax,
    position_mask,
)

_M32 = 0xFFFFFFFF


@key_cache(maxsize=256)
def _siv_key_setup(key: bytes, nonce: bytes, device: torch.device):
    """Per-(key, nonce) state: the message key, its key planes
    int32[R+1,8,16] and the plane-ordered POLYVAL power tables of the auth
    key (ghash_bulk.ghash_power_tables; the packed level-1 operand of K4
    and K5-open at tables[5]), on `device`.  About 2.1 MiB of device
    tensors per entry, so a full cache holds about 540 MiB."""
    auth_key, msg_key = _derive_keys(key, nonce)
    tables = ghash_power_tables(polyval_matrix(np.frombuffer(auth_key, np.uint8)),
                                device=device)
    return msg_key, u32_tensor(key_planes(expand_key(msg_key)), device), tables


def siv_key_setup_from_jax(msg_key, kp, tables, *, device="cuda"):
    """The JAX package's _siv_key_setup outputs (msg_key and, as numpy
    arrays, the key planes and tables; its transposed w1t is tables[0]
    again) -> the port's (msg_key, kp, tables) on `device`, so that both
    packages can be run from one per-(key, nonce) state."""
    kp_t, tables_t = key_setup_from_jax(kp, tables, device=device)
    return bytes(msg_key), kp_t, tables_t


def _stream_words(n_blocks: int) -> int:
    """Stream width W for n message blocks and the trailing length block,
    rounded up to whole level-2 groups of 32 words."""
    w = -(-(n_blocks + 1) // 32)
    return w + (-w) % max(SEAL_WORD_ALIGN, 32)


def _siv_basew(tag_words: torch.Tensor, front: int) -> torch.Tensor:
    """Kernel operand basew int32[1, 128] from the counter block's four
    words (int32[4], little-endian): lane 4j+k = word k, with the stream
    front subtracted from word 0 (mod 2^32), so that stream position p
    counts from word 0 + p."""
    words = tag_words.view(torch.int32).to(torch.int64) & _M32
    words[0] = (words[0] - front) & _M32
    return i32_from_u32(words.repeat(32))[None, :]


def _len_block_le(n_blocks: int) -> np.ndarray:
    """The POLYVAL length block of a message of n blocks and no AAD."""
    return _lengths_le(0, n_blocks * BLOCK)[0]


def polyval_stream(tables, data_stream, n: int) -> torch.Tensor:
    """Seal pass 1 on the shared stream: POLYVAL over stream positions
    [front, 32W), the message and the length block at the last position
    -> the accumulator block uint8[16]."""
    w = data_stream.shape[0]
    ghm = position_mask(w, 32 * w - (n + 1), 32 * w, data_stream.device)
    return bits_to_blocks(fold_level1(ghash1_fused(ghm, tables[5], data_stream), tables))


def gcm_siv_ctr_stream(kp, tag_words, data_stream, front: int) -> torch.Tensor:
    """Seal pass 2 (and the CTR of an open) on the shared stream: the
    keystream from the counter block's words, data at stream positions
    front..  Self-inverse."""
    return siv_ctrw_fused(kp.reshape(-1, 1), _siv_basew(tag_words, front), data_stream)


def _siv_open_stream(kp, tag_words, tables, ct_stream, n: int):
    """The fused open pass and its tag math -> (pt stream, POLYVAL block)."""
    w = ct_stream.shape[0]
    front = 32 * w - (n + 1)
    dev = ct_stream.device
    ghm = position_mask(w, front, 32 * w - 1, dev)  # the message only
    ptw, s1t = siv_open_fused(kp.reshape(-1, 1), _siv_basew(tag_words, front), ghm,
                              tables[5], ct_stream)
    # the length block sits at the last stream position: exponent M^1
    len_bits = blocks_to_bits(torch.from_numpy(_len_block_le(n)).to(dev))
    corr = _gf2_matmul_i8(len_bits.to(torch.int8)[None], tables[3].T.to(torch.int8))[0]
    return ptw, bits_to_blocks(fold_level1(s1t, tables) ^ corr.to(torch.uint8))


def _counter_block(tag: torch.Tensor) -> torch.Tensor:
    """The first counter block: the tag with bit 7 of byte 15 set, as
    int32[4] words."""
    base = tag.clone()
    base[15] |= 0x80
    return base.view(torch.int32)


def gcm_siv_seal(key, nonce, plaintext, *, device="cuda") -> bytes:
    """Bulk GCM-SIV seal -> ciphertext || 16-byte tag: 12-byte nonce, no
    AAD, whole-block plaintext (modes/gcm_siv.gcm_siv_encrypt for the
    rest)."""
    key, nonce, pt = bytes(key), _nonce(nonce), bytes(plaintext)
    dev = torch.device(device)
    n = _whole_blocks(pt, "message")
    msg_key, kp, tables = _siv_key_setup(key, nonce, dev)
    w = _stream_words(n)
    front = 32 * w - (n + 1)
    buf = host_stream(pt, front, w)
    buf.reshape(-1)[-4:] = _len_block_le(n).view(np.uint32)
    stream = torch.from_numpy(buf.view(np.int32)).to(dev)
    tag = siv_tag(msg_key, nonce, polyval_stream(tables, stream, n))
    ctw = gcm_siv_ctr_stream(kp, _counter_block(tag), stream, front)
    return _from_device_stream(ctw, front, len(pt)) + bytes(tag.cpu().numpy())


def gcm_siv_open(key, nonce, ct_and_tag, *, device="cuda") -> bytes:
    """Bulk GCM-SIV open: decrypt with the received tag, recompute the tag
    over the plaintext and verify it BEFORE any plaintext is returned;
    raises AuthenticationError on a mismatch.  Constraints as
    gcm_siv_seal."""
    key, nonce, data = bytes(key), _nonce(nonce), bytes(ct_and_tag)
    if len(data) < BLOCK:
        raise ValueError("ciphertext shorter than the 16-byte tag")
    dev = torch.device(device)
    ct, tag = data[:-BLOCK], data[-BLOCK:]
    n = _whole_blocks(ct, "message")
    msg_key, kp, tables = _siv_key_setup(key, nonce, dev)
    w = _stream_words(n)
    front = 32 * w - (n + 1)
    tag_t = torch.frombuffer(bytearray(tag), dtype=torch.uint8).to(dev)
    ptw, pv = _siv_open_stream(kp, _counter_block(tag_t), tables,
                               _to_device_stream(ct, front, w, dev), n)
    if not verify_tag(siv_tag(msg_key, nonce, pv), tag):
        raise AuthenticationError("GCM-SIV tag mismatch")
    return _from_device_stream(ptw, front, len(ct))
