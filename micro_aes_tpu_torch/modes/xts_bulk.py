"""Bulk XTS disk-sector engine: many whole sectors in one call.

The reference doubles the tweak serially per block (micro_aes.c:1035).
Doubling in GF(2^128) is linear over GF(2), so each sector's tweak chain
T·α^j splits:

    T0 = E_k2(sector tweak)                 (K2, the bitsliced cipher)
    base[s, r] = D^(32r) @ bits(T0[s])      (one GF(2) product: a base per
                                             32-block stream row)
    off[block jj of the row] = base·α^jj    (inside K6, five masked
                                             plane-relabel stages)
    out = off ^ C_k1(off ^ data)            (K6, ops/xex_kernels.xex_fused)

so only data-sized streams move through device memory.  Sector sizes that
are not a multiple of 32 blocks take the fallback: every tweak of the
sector from one GF(2) product with the stacked powers D^j, and the body on
K2 (`xts_sectors_kernel`).  The GF(2) products are float64 products mod 2
on the request's device (ops/ghash_bulk), exact whatever the matmul
precision.

Whole sectors only: the stealing tail stays on modes/xts (disk sectors are
whole blocks by construction).  Every public entry point takes `device=`
("cuda" unless the caller asks for the CPU); the kernels run on CUDA, their
plain versions on the CPU.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.bitslice import key_planes, pack_planes, unpack_planes
from ..core.keyschedule import expand_key
from ..errors import DataLengthError
from ..ops.cipher_kernel import cipher_planes
from ..ops.gf128 import _bits_np, _unit_blocks, bits_to_blocks, blocks_to_bits
from ..ops.ghash_bulk import _gf2_matmul_i8
from ..ops.mac import double_le_np
from ..ops.seal_kernels import SEAL_WORD_ALIGN
from ..ops.xex_kernels import xex_fused
from ..utils.bytesio import BLOCK, to_u8, u32_tensor
from ..utils.keycache import key_cache
from .seal import _from_device_stream, _to_device_stream
from .xts import sector_tweak

BLOCKS_PER_SECTOR_MAX = 512  # up to 8 KiB sectors


def _doubling_bits(count: int, step: int) -> np.ndarray:
    """uint8[count, 128 in, 128 out]: entry m is (D^(step m))^T, D the
    little-endian doubling map (micro_aes.c:449-458): row i holds the bits
    of e_i doubled step*m times, so bits_row @ entry m = D^(step m) bits."""
    units = _unit_blocks()
    out = np.zeros((count, 128, 128), np.uint8)
    for m in range(count):
        out[m] = _bits_np(units)
        for _ in range(step):
            units = double_le_np(units)
    return out


@functools.lru_cache(maxsize=8)
def _double_powers_t(nblocks: int, device: torch.device) -> torch.Tensor:
    """int8 [J, 128, 128]: (D^j)^T for j = 0..J-1 (the fallback's tweaks)."""
    return torch.from_numpy(_doubling_bits(nblocks, 1).astype(np.int8)).to(device)


@functools.lru_cache(maxsize=8)
def _row_base_powers_t(r_per_sector: int, device: torch.device) -> torch.Tensor:
    """int8 [128, R*128]: (D^(32r))^T for r = 0..R-1 side by side, so that
    tbits [S, 128] @ P gives every stream row's base bits in (s, r) order."""
    p = _doubling_bits(r_per_sector, 32).transpose(1, 0, 2).reshape(128, -1)
    return torch.from_numpy(np.ascontiguousarray(p).astype(np.int8)).to(device)


@key_cache(maxsize=64)
def _xts_key_setup(keys: bytes, device: torch.device):
    """Key planes int32[R+1,8,16] of key1 (the data key) and key2 (the
    tweak key) on `device`."""
    klen = len(keys) // 2
    return tuple(u32_tensor(key_planes(expand_key(k)), device)
                 for k in (keys[:klen], keys[klen:]))


def xts_state_from_jax(kp1, kp2, pows_t, *, device="cuda"):
    """The JAX package's per-key XTS arrays (as numpy: the key planes of
    `_prepare` and the `_double_powers_t` or `_row_base_powers_t` table) ->
    the port's device tensors, so that both packages run on one state."""
    dev = torch.device(device)
    return (u32_tensor(kp1, dev), u32_tensor(kp2, dev),
            torch.from_numpy(np.array(pows_t, np.int8)).to(dev))


def _cipher_blocks(kp, blocks: torch.Tensor, decrypt: bool = False) -> torch.Tensor:
    """The bitsliced cipher (K2) over uint8[N,16], padded to 32 blocks."""
    n = blocks.shape[0]
    blocks = torch.nn.functional.pad(blocks, (0, 0, 0, (-n) % 32))
    return unpack_planes(cipher_planes(kp, pack_planes(blocks), decrypt), n)


def xts_sectors_kernel(kp1, kp2, pows_t, tweaks, data, decrypt: bool = False):
    """The fallback for any sector size: tweaks uint8[S,16], data
    uint8[S,J,16], pows_t from _double_powers_t(J) -> uint8[S,J,16]."""
    s, j, _ = data.shape
    tbits = blocks_to_bits(_cipher_blocks(kp2, tweaks)).to(torch.int8)     # E_k2(tweak)
    tw = _gf2_matmul_i8(tbits, pows_t.permute(1, 0, 2).reshape(128, j * 128))
    tw = bits_to_blocks(tw.reshape(s, j, 128))
    y = _cipher_blocks(kp1, (data ^ tw).reshape(s * j, BLOCK), decrypt)
    return y.reshape(s, j, BLOCK) ^ tw


def xts_sectors_stream_kernel(kp1, kp2, pows_t, tweaks, ptw, decrypt: bool = False):
    """The stream engine (J % 32 == 0): tweaks uint8[S,16], ptw the w-major
    [W, 128] stream of the sectors (stream position = sector-major block
    index), pows_t from _row_base_powers_t(J // 32) -> the output stream."""
    w = ptw.shape[0]
    w_real = tweaks.shape[0] * (pows_t.shape[1] // 128)
    tbits = blocks_to_bits(_cipher_blocks(kp2, tweaks)).to(torch.int8)
    bases = _gf2_matmul_i8(tbits, pows_t).reshape(w_real, 128)
    # gf128 bit order back to bytes, read as little-endian words (the JAX
    # package's _VAL_PERM permutation), one base per lane group of its row
    words = bits_to_blocks(bases).view(torch.int32)
    basew = torch.nn.functional.pad(words.repeat(1, 32), (0, 0, 0, w - w_real))
    return xex_fused(kp1.reshape(-1, 1), basew, ptw, decrypt)


def _tweak_block(sector_id) -> np.ndarray:
    if isinstance(sector_id, (bytes, bytearray, np.ndarray)):
        t = np.zeros(BLOCK, np.uint8)
        raw = np.frombuffer(bytes(sector_id), np.uint8)[:BLOCK]
        t[: len(raw)] = raw
        return t
    return sector_tweak(sector_id)  # an integer LBA, little-endian


def _prepare(keys, sector_ids, data, sector_size: int, device: torch.device):
    """-> (kp1, kp2, tweaks uint8[S,16] on device, host bytes, J)."""
    keys = bytes(keys)
    flat = to_u8(data)
    if sector_size <= 0 or sector_size % BLOCK or len(flat) % sector_size:
        raise DataLengthError("data must be whole 16-byte-aligned sectors")
    j = sector_size // BLOCK
    if j > BLOCKS_PER_SECTOR_MAX:
        raise DataLengthError(f"sector size > {BLOCKS_PER_SECTOR_MAX * BLOCK}")
    s = len(flat) // sector_size
    ids = list(sector_ids)
    if len(ids) != s:
        raise DataLengthError(f"{len(ids)} sector ids for {s} sectors")
    tweaks = np.stack([_tweak_block(sid) for sid in ids]) if s else np.zeros((0, BLOCK), np.uint8)
    kp1, kp2 = _xts_key_setup(keys, device)
    return kp1, kp2, torch.from_numpy(tweaks).to(device), flat, j


def _run_sectors(keys, sector_ids, data, sector_size: int, decrypt: bool, device) -> bytes:
    dev = torch.device(device)
    kp1, kp2, tweaks, flat, j = _prepare(keys, sector_ids, data, sector_size, dev)
    if not len(flat):
        return b""
    if j % 32 == 0:
        w = len(flat) // (32 * BLOCK)
        w += (-w) % SEAL_WORD_ALIGN
        out = xts_sectors_stream_kernel(kp1, kp2, _row_base_powers_t(j // 32, dev), tweaks,
                                        _to_device_stream(flat, 0, w, dev), decrypt)
        return _from_device_stream(out, 0, len(flat))
    blocks = torch.from_numpy(flat.reshape(-1, j, BLOCK).copy()).to(dev)
    out = xts_sectors_kernel(kp1, kp2, _double_powers_t(j, dev), tweaks, blocks, decrypt)
    return bytes(out.cpu().numpy().reshape(-1))


def xts_seal_sectors(keys, sector_ids, data, sector_size: int = 4096, *,
                     device="cuda") -> bytes:
    """Encrypt S whole sectors, sector i under the tweak sector_ids[i]: an
    integer (little-endian, as dm-crypt's plain64 LBA) or a tweak block of
    up to 16 bytes.  keys = key1 || key2."""
    return _run_sectors(keys, sector_ids, data, sector_size, False, device)


def xts_open_sectors(keys, sector_ids, data, sector_size: int = 4096, *,
                     device="cuda") -> bytes:
    """Decrypt S whole sectors (the inverse of xts_seal_sectors)."""
    return _run_sectors(keys, sector_ids, data, sector_size, True, device)
