"""Fused single-key bulk AES-GCM ("seal") and bulk CTR — the throughput
engine.

Pipeline, bit-plane resident (no per-block byte shuffles):

  counter planes -> bitsliced cipher -> keystream xor -> level-1 GHASH of
  every 32-block row (all inside K1, ops/seal_kernels.seal_fused)
    -> level 2, combine, trailing-pad and AAD adjusts, finalize
       (GF(2) matrix products, ops/ghash_bulk) -> tag.

Layout facts it relies on:
  * counter values are consecutive, so with a 32-aligned generation start
    every bit-plane word is either a fixed lane pattern (bits 0..4) or a
    per-word broadcast (bits >= 5);
  * a 12-byte-nonce J0 has low word 1, so the stream starts at counter
    J0 - 1: position 1 holds E(J0) and the message occupies positions
    2..n+1;
  * leading zero blocks are free in GHASH (exponents count from the end),
    so tile padding always goes in front, and the z trailing stream
    positions are compensated by one cached matrix (_trail_adjust_t).

Every public entry point takes `device=` ("cuda" unless the caller asks
for the CPU); the kernels run on a CUDA device, their plain PyTorch
versions on the CPU.  This path needs a 12-byte nonce and a whole-block
message; AAD may have any length.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.bitslice import (
    blocks_to_words,
    key_planes,
    planes_to_words,
    words_to_blocks,
    words_to_planes,
)
from ..core.cipher import encrypt_blocks_np
from ..core.keyschedule import expand_key
from ..errors import AuthenticationError
from ..ops.cipher_kernel import cipher_planes
from ..ops.counter import counter_planes_be, j0_planes, lohi_words
from ..ops.gf128 import blocks_to_bits, ghash_matrix, gf2_matinv_np, mat_power_gf2_np
from ..ops.ghash_bulk import (
    CHUNK,
    CHUNK2,
    _gf2_matmul_i8,
    fold_level1,
    ghash_finalize,
    ghash_from_bits,
    ghash_power_tables,
    pack_level1,
    planes_to_bits_i8,
)
from ..ops.seal_kernels import (
    SEAL_WORD_ALIGN,
    bytes_to_stream,
    ctr_fused,
    seal_fused,
    stream_to_bytes,
)
from ..utils.bytesio import BLOCK, u32_tensor, verify_tag
from ..utils.keycache import key_cache


@key_cache(maxsize=64)
def _key_setup(key: bytes, device: torch.device):
    rk = expand_key(key)
    kp = u32_tensor(key_planes(rk), device)
    h = encrypt_blocks_np(key, np.zeros((1, BLOCK), np.uint8))[0]
    return kp, ghash_power_tables(ghash_matrix(h), device=device)


def gcm_key_setup(key, *, device="cuda"):
    """Per-key precompute: bitsliced key planes int32[R+1,8,16] and the
    plane-ordered GHASH power tables (ghash_bulk.ghash_power_tables, with
    the seal kernel's packed level-1 operand last), on `device`."""
    return _key_setup(bytes(key), torch.device(device))


def key_setup_from_jax(kp, tables, *, device="cuda"):
    """The JAX package's gcm_key_setup output (as numpy arrays) -> the
    port's (key planes, tables) on `device`, so that both packages can be
    run from one per-key state.  The seal kernel's packed operand is
    derived from the JAX W1."""
    def i8(a):
        return torch.from_numpy(np.asarray(a).astype(np.int8)).to(device)

    w1, w2, m_outer, m_h, spans = tables
    return u32_tensor(np.asarray(kp), device), (
        i8(w1), i8(w2), i8(m_outer),
        torch.from_numpy(np.asarray(m_h, np.uint8).copy()).to(device),
        tuple((i8(ws), i8(mn)) for ws, mn in spans),
        torch.from_numpy(pack_level1(np.asarray(w1))).to(device))


def _len_block(n_blocks: int, aad_bytes: int, device) -> torch.Tensor:
    lb = np.zeros(BLOCK, np.uint8)
    lb[:8] = np.frombuffer((aad_bytes * 8).to_bytes(8, "big"), np.uint8)
    lb[8:] = np.frombuffer((n_blocks * BLOCK * 8).to_bytes(8, "big"), np.uint8)
    return torch.from_numpy(lb).to(device)


# std GHASH bit index q_std = 8p + (7-b)  ->  plane-order index b*16 + p
_STD2PLANE = np.array(
    [8 * (q % 16) + 7 - q // 16 for q in range(128)], dtype=np.int64
)


def _ghash_pad_front(bits: torch.Tensor) -> torch.Tensor:
    """Front-pad bit rows to whole level-2 groups (leading zero blocks
    are free in GHASH)."""
    pad = (-bits.shape[0]) % (CHUNK * CHUNK2)
    if pad:
        bits = torch.cat([bits.new_zeros((pad, 128)), bits], dim=0)
    return bits


def stream_words(n_positions: int, align: int = SEAL_WORD_ALIGN) -> int:
    """Words (32 stream positions each) that hold n_positions, rounded up
    to a multiple of `align` words."""
    w = -(-n_positions // 32)
    return w + (-w) % align


def plane_seal_body(kp, tables, j0, pt_blocks, start: int = -1):
    """The v2 pipeline on K2 (ops/cipher_kernel.cipher_planes): counter
    planes -> cipher -> xor -> GHASH over plane-order bit rows.  Stream
    position q holds counter value J0 + start + q (start = -1 for a whole
    message; s*L - 1 for the block shard s of the sharded seal), the data
    positions 2..N+1.  kp int32[R+1,8,16], j0 uint8[16] with low word 1,
    pt_blocks uint8[N,16], all on one device -> (ct_blocks uint8[N,16], the
    cipher of position 1 uint8[16] (E(J0) for a whole message), the GHASH
    partial uint8[128] of the ciphertext)."""
    n = pt_blocks.shape[0]
    nwords = stream_words(n + 2)
    ks_planes = cipher_planes(kp, counter_planes_be(j0, nwords, start))

    pt_words = blocks_to_words(pt_blocks)  # [4, N]
    pt_words = torch.nn.functional.pad(pt_words, (2, 32 * nwords - n - 2))
    ct_planes = words_to_planes(pt_words) ^ ks_planes

    ct_words = planes_to_words(ct_planes)  # [4, 32*nwords]
    bits = _ghash_pad_front(planes_to_bits_i8(ct_planes)[2: n + 2])
    return (words_to_blocks(ct_words[:, 2: n + 2]), words_to_blocks(ct_words[:, 1:2])[0],
            ghash_from_bits(tables, bits))


def gcm_seal_kernel(kp, tables, j0, pt_blocks):
    """The v2 seal on K2 of a whole message: j0 with low word 1 (a 12-byte
    nonce), so position 1 holds E(J0) -> (ct_blocks uint8[N,16], tag
    uint8[16])."""
    ct, ek_j0, acc = plane_seal_body(kp, tables, j0, pt_blocks)
    return ct, ek_j0 ^ ghash_finalize(tables, acc, _len_block(pt_blocks.shape[0], 0, j0.device))


@key_cache(maxsize=512)
def _trail_adjust_t(key: bytes, z: int, device: torch.device):
    """((M_H^z)^-1)^T as int8: compensates the z trailing masked stream
    positions of the fused kernel (exponents count from the stream end)."""
    _, tables = _key_setup(key, device)
    m_h = tables[3].cpu().numpy()
    mz = mat_power_gf2_np(m_h, z) if z else np.eye(128, dtype=np.uint8)
    return torch.from_numpy(gf2_matinv_np(mz).T.astype(np.int8)).to(device)


def seal_stream_words(n_blocks: int) -> int:
    """Stream width W (rows of the [W, 128] stream) for a message of n
    blocks: data at positions 2..n+1, rounded up to whole level-2 groups
    (lcm(SEAL_WORD_ALIGN, CHUNK2) words)."""
    return stream_words(n_blocks + 2, math.lcm(SEAL_WORD_ALIGN, CHUNK2))


def fused_trailing_pad(n_blocks: int) -> int:
    """z = number of trailing masked stream positions for n blocks."""
    return 32 * seal_stream_words(n_blocks) - n_blocks - 2


def position_mask(w: int, lo: int, hi: int, device) -> torch.Tensor:
    """Kernel operand ghmask: int32[1, W], bit j of word w set iff stream
    position 32w+j lies in [lo, hi)."""
    base = 32 * np.arange(w, dtype=np.int64)
    first = np.clip(lo - base, 0, 32)  # first valid lane of each word
    end = np.clip(hi - base, 0, 32)    # one past the last valid lane
    one = np.int64(1)
    mask = ((one << end) - 1) & ~((one << first) - 1)
    return u32_tensor(mask.astype(np.uint32)[None, :], device)


def ghash_mask(n: int, w: int, device) -> torch.Tensor:
    """The seal stream's ghmask: the message blocks at positions [2, n+2)."""
    return position_mask(w, 2, n + 2, device)


def fused_seal_stream(kp, tables, j0, pt_stream, n: int,
                      open_direction: bool = False, start: int = -1):
    """Fused-kernel core, stream form: pt_stream is the w-major [W, 128]
    stream with the message at positions 2..n+1.  Returns (out_stream,
    ek_j0 uint8[16], acc uint8[128]) where acc is the GHASH partial before
    the trailing-pad compensation.  `start` is the counter offset of stream
    position 0 relative to J0 (-1 for a whole message) and must keep the
    generation 32-aligned."""
    w = pt_stream.shape[0]
    ctw, s1t = seal_fused(kp.reshape(-1, 1), j0_planes(j0),
                          lohi_words(j0, w, start),
                          ghash_mask(n, w, pt_stream.device),
                          tables[5], pt_stream,
                          bits_from_input=open_direction)
    ek_j0 = ctw[0, 4:8].contiguous().view(torch.uint8)
    return ctw, ek_j0, fold_level1(s1t, tables)


def fused_seal_body(kp, tables, j0, pt_blocks, open_direction: bool = False,
                    start: int = -1):
    """Blocks-form wrapper over fused_seal_stream (the sharded engine's
    arrays are [N, 16] blocks): pt_blocks uint8[N,16] -> (out uint8[N,16],
    ek_j0 uint8[16], acc uint8[128]), acc the GHASH partial before the
    trailing-pad compensation.  A block shard s of L blocks passes
    start = s*L - 1 (L a multiple of 32, so the generation stays
    32-aligned); the relayouts to and from the stream run on the device."""
    n = pt_blocks.shape[0]
    ptw = bytes_to_stream(pt_blocks, 2, seal_stream_words(n))
    ctw, ek_j0, acc = fused_seal_stream(kp, tables, j0, ptw, n, open_direction, start)
    return stream_to_bytes(ctw, 2, n), ek_j0, acc


@key_cache(maxsize=512)
def _aad_shift_t(key: bytes, n_ct_blocks: int, device: torch.device):
    """(M_H^n)^T as int8: shifts the AAD partial past the n ciphertext
    blocks, G = M^n G_aad ^ G_ct."""
    _, tables = _key_setup(key, device)
    mt = mat_power_gf2_np(tables[3].cpu().numpy(), n_ct_blocks).T
    return torch.from_numpy(mt.astype(np.int8)).to(device)


def _aad_fold(tables, acc, aad_blocks, aad_shift_t):
    """Fold the AAD GHASH partial in front of the ciphertext partial."""
    perm = torch.as_tensor(_STD2PLANE, device=aad_blocks.device)
    abits = blocks_to_bits(aad_blocks).to(torch.int8)[:, perm]
    g_aad = ghash_from_bits(tables, _ghash_pad_front(abits))
    return acc ^ _gf2_matmul_i8(g_aad.to(torch.int8), aad_shift_t)


def gcm_seal_stream_fused(kp, tables, trail_adj_t, j0, pt_stream, n: int,
                          open_direction: bool = False,
                          aad_blocks=None, aad_bytes: int = 0,
                          aad_shift_t=None):
    """Stream-form fused seal/open: stream in, stream out.  Returns
    (out_stream, tag uint8[16])."""
    ctw, ek_j0, acc = fused_seal_stream(kp, tables, j0, pt_stream, n,
                                        open_direction)
    acc = _gf2_matmul_i8(acc.to(torch.int8), trail_adj_t)
    if aad_blocks is not None and aad_blocks.shape[0]:
        acc = _aad_fold(tables, acc, aad_blocks, aad_shift_t)
    acc = acc.to(torch.uint8)
    tag = ek_j0 ^ ghash_finalize(tables, acc,
                                 _len_block(n, aad_bytes, pt_stream.device))
    return ctw, tag


def gcm_seal_kernel_fused(kp, tables, trail_adj_t, j0, pt_blocks,
                          open_direction: bool = False, aad_blocks=None,
                          aad_bytes: int = 0, aad_shift_t=None):
    """Fused seal/open of a whole message in blocks form: the body, the
    trailing-pad compensation (trail_adj_t = _trail_adjust_t of its pad),
    the AAD fold (aad_blocks uint8[Na,16], zero-padded tail, shifted by
    aad_shift_t) and the tag -> (out uint8[N,16], tag uint8[16])."""
    n = pt_blocks.shape[0]
    out, ek_j0, acc = fused_seal_body(kp, tables, j0, pt_blocks, open_direction)
    acc = _gf2_matmul_i8(acc.to(torch.int8), trail_adj_t)
    if aad_blocks is not None and aad_blocks.shape[0]:
        acc = _aad_fold(tables, acc, aad_blocks, aad_shift_t)
    tag = ek_j0 ^ ghash_finalize(tables, acc.to(torch.uint8),
                                 _len_block(n, aad_bytes, pt_blocks.device))
    return out, tag


def host_stream(data: bytes, front_pos: int, w: int) -> np.ndarray:
    """Host bytes -> w-major uint32[W, 128] stream (one copy into the
    zero-padded buffer)."""
    words = np.frombuffer(data, np.uint32)
    out = np.zeros(w * 128, np.uint32)
    out[4 * front_pos: 4 * front_pos + len(words)] = words
    return out.reshape(w, 128)


def host_unstream(stream: np.ndarray, front_pos: int, nbytes: int) -> bytes:
    """Host stream -> bytes from position front_pos (one copy)."""
    flat = np.ascontiguousarray(stream).view(np.uint32).reshape(-1)
    return flat[4 * front_pos: 4 * front_pos + nbytes // 4].tobytes()


def _to_device_stream(data: bytes, front_pos: int, w: int, device) -> torch.Tensor:
    return torch.from_numpy(host_stream(data, front_pos, w).view(np.int32)).to(device)


def _from_device_stream(stream: torch.Tensor, front_pos: int, nbytes: int) -> bytes:
    return host_unstream(stream.cpu().numpy(), front_pos, nbytes)


def _aad_prep(key, aad, n_ct_blocks, device):
    aad = bytes(aad or b"")
    if not aad:
        return None, 0, None
    na = -(-len(aad) // BLOCK)
    blocks = np.zeros((na, BLOCK), np.uint8)
    blocks.reshape(-1)[: len(aad)] = np.frombuffer(aad, np.uint8)
    return (torch.from_numpy(blocks).to(device), len(aad),
            _aad_shift_t(key, n_ct_blocks, device))


def _j0_block(nonce, device) -> torch.Tensor:
    nonce = bytes(nonce)
    if len(nonce) != 12:
        raise ValueError("the bulk GCM path requires a 12-byte nonce")
    j0 = np.zeros(BLOCK, np.uint8)
    j0[:12] = np.frombuffer(nonce, np.uint8)
    j0[15] = 1
    return torch.from_numpy(j0).to(device)


def _whole_blocks(data: bytes, what: str) -> int:
    if len(data) % BLOCK:
        raise ValueError(f"the bulk path needs a whole-block {what}")
    return len(data) // BLOCK


def _seal_or_open(key, nonce, data: bytes, aad, device, open_direction):
    dev = torch.device(device)
    n = _whole_blocks(data, "message")
    kp, tables = gcm_key_setup(key, device=dev)
    w = seal_stream_words(n)
    adj = _trail_adjust_t(key, fused_trailing_pad(n), dev)
    ab, alen, ashift = _aad_prep(key, aad, n, dev)
    return gcm_seal_stream_fused(
        kp, tables, adj, _j0_block(nonce, dev),
        _to_device_stream(data, 2, w, dev), n, open_direction=open_direction,
        aad_blocks=ab, aad_bytes=alen, aad_shift_t=ashift)


def gcm_seal(key, nonce, plaintext, aad: bytes = b"", *, device="cuda") -> bytes:
    """Bulk seal -> ciphertext || 16-byte tag.  12-byte nonce, whole-block
    plaintext, optional AAD of any length."""
    key, plaintext = bytes(key), bytes(plaintext)
    ctw, tag = _seal_or_open(key, nonce, plaintext, aad, device, False)
    return _from_device_stream(ctw, 2, len(plaintext)) + bytes(tag.cpu().numpy())


def gcm_open(key, nonce, ct_and_tag, aad: bytes = b"", *, device="cuda") -> bytes:
    """Bulk open: verifies the tag BEFORE any plaintext leaves the device;
    raises AuthenticationError on a mismatch.  Constraints as gcm_seal."""
    key, data = bytes(key), bytes(ct_and_tag)
    if len(data) < 16:
        raise ValueError("ciphertext shorter than the 16-byte tag")
    ct, tag = data[:-16], data[-16:]
    ptw, got = _seal_or_open(key, nonce, ct, aad, device, True)
    if not verify_tag(got, tag):
        raise AuthenticationError("GCM tag mismatch")
    return _from_device_stream(ptw, 2, len(ct))


def ctr_bulk_stream(kp, ctr0, pt_stream):
    """Fused bulk CTR (CTR_NA semantics), stream form: ctr0 = nonce || 0^3
    || 0x01 block on the stream's device; data occupies stream positions
    1.. (counter value = position: CTR starts at 1 and generation starts
    32-aligned at 0)."""
    w = pt_stream.shape[0]
    return ctr_fused(kp.reshape(-1, 1), j0_planes(ctr0),
                     lohi_words(ctr0, w, -1), pt_stream)


def ctr_bulk(key, iv, data, *, device="cuda") -> bytes:
    """Bulk CTR encrypt/decrypt (self-inverse): 12-byte nonce with the
    RFC-3686 start value (counter block nonce || 0^3 || 0x01), data a
    whole-block multiple."""
    key, iv, data = bytes(key), bytes(iv), bytes(data)
    if len(iv) < 12:
        raise ValueError("ctr_bulk needs a nonce of at least 12 bytes")
    dev = torch.device(device)
    n = _whole_blocks(data, "message")
    w = stream_words(n + 1)
    ctr0 = np.zeros(BLOCK, np.uint8)
    ctr0[:12] = np.frombuffer(iv[:12], np.uint8)
    ctr0[15] = 1  # CTR_START_VALUE (micro_aes.h:98)
    kp, _ = gcm_key_setup(key, device=dev)
    out = ctr_bulk_stream(kp, torch.from_numpy(ctr0).to(dev),
                          _to_device_stream(data, 1, w, dev))
    return _from_device_stream(out, 1, len(data))
