"""Parity of the port's XTS (micro_aes_tpu_torch: the ops/mac doublings,
the modes/common batched cipher, modes/xts, the K6 and K8 plain versions of
ops/xex_kernels and modes/xts_bulk) with the JAX package, on the CPU.

Inputs come from numpy seeds and go through both packages; every output is
an integer array or bytes and every comparison is bit-exact.  The JAX
kernel twins and sector kernels run eagerly under jax.disable_jit at a few
stream rows (an XLA compile of a bulk engine costs 10-20 s per shape); the
JAX per-message path runs jitted on a few shape buckets.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import micro_aes_tpu.modes.xts_bulk as jxb
import micro_aes_tpu.ops.pallas_seal as jps
from micro_aes_tpu.modes.common import dec_blocks_np as j_dec_blocks_np
from micro_aes_tpu.modes.common import enc_blocks_np as j_enc_blocks_np
from micro_aes_tpu.modes.seal import host_stream as j_host_stream
from micro_aes_tpu.modes.xts import xts_decrypt as j_xts_decrypt
from micro_aes_tpu.modes.xts import xts_encrypt as j_xts_encrypt
from micro_aes_tpu.ops.mac import double_be_np as j_double_be_np
from micro_aes_tpu.ops.mac import double_le_np as j_double_le_np

import micro_aes_tpu_torch as aes
import micro_aes_tpu_torch.modes.xts_bulk as txb
from micro_aes_tpu_torch import DataLengthError
from micro_aes_tpu_torch.modes.common import dec_blocks_np, enc_blocks_np
from micro_aes_tpu_torch.modes.seal import host_stream
from micro_aes_tpu_torch.ops import xex_kernels
from micro_aes_tpu_torch.ops.mac import double_be_np, double_le_np
from micro_aes_tpu_torch.testing.kat import XTS_VECTORS

CPU = "cpu"


def _rand(rng, n) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.uint32).view(np.int32).copy())


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


def test_doublings_and_batched_cipher_match_jax():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (7, 16), dtype=np.uint8)
    x[0, 0] = x[1, 15] = 0x80  # the bits that fall out and take the 0x87 taps
    assert np.array_equal(double_be_np(x), j_double_be_np(x))
    assert np.array_equal(double_le_np(x), j_double_le_np(x))
    key = _rand(rng, 24)
    assert np.array_equal(enc_blocks_np(key, x, CPU), j_enc_blocks_np(key, x))
    assert np.array_equal(dec_blocks_np(key, x, CPU), j_dec_blocks_np(key, x))


@pytest.mark.parametrize("klen,decrypt", [(16, False), (32, True)])
def test_xex_and_ctrw_plain_versions_match_jax_twins(klen, decrypt):
    """K6 and K8 plain versions vs xex_fused_jnp and ctrw_fused_jnp at W = 8,
    a different random base in every lane."""
    rng = np.random.default_rng(klen)
    kp, _ = aes.gcm_key_setup(_rand(rng, klen), device=CPU)
    kpf = kp.numpy().view(np.uint32).reshape(-1, 1)
    x = rng.integers(0, 2**32, (8, 128), dtype=np.uint32)
    y = rng.integers(0, 2**32, (8, 128), dtype=np.uint32)
    with jax.disable_jit():
        jxex = jps.xex_fused_jnp(jnp.asarray(kpf), jnp.asarray(y), jnp.asarray(x), decrypt=decrypt)
        jctr = jps.ctrw_fused_jnp(jnp.asarray(kpf), jnp.asarray(y), jnp.asarray(x), decrypt=decrypt)
    got = xex_kernels.xex_fused(_i32(kpf), _i32(y), _i32(x), decrypt)
    assert np.array_equal(_u32(got), np.asarray(jxex))
    got = xex_kernels.ctrw_fused(_i32(kpf), _i32(y), _i32(x), decrypt)
    assert np.array_equal(_u32(got), np.asarray(jctr))


@pytest.mark.parametrize("vector", XTS_VECTORS, ids=lambda v: v[0])
def test_xts_vectors(vector):
    name, keys, tweak, pt, ct = vector
    assert aes.xts_encrypt(keys, tweak, pt, device=CPU) == ct
    assert aes.xts_decrypt(keys, tweak, ct, device=CPU) == pt


@pytest.mark.parametrize("residue", range(16))
def test_xts_per_message_matches_jax(residue):
    """Whole blocks (residue 0) and byte ciphertext stealing of every
    residue 1..15, AES-128 and AES-256 pairs, explicit and integer tweaks."""
    rng = np.random.default_rng(200 + residue)
    keys = _rand(rng, (32, 64)[residue % 2])
    data = _rand(rng, 16 * (1 + residue % 3) + residue)
    tweak = _rand(rng, 16) if residue % 3 else None
    sid = int(rng.integers(0, 2**62)) * (residue + 1)
    ct = aes.xts_encrypt(keys, tweak, data, sector_id=sid, device=CPU)
    assert ct == j_xts_encrypt(keys, tweak, data, sector_id=sid)
    assert aes.xts_decrypt(keys, tweak, ct, sector_id=sid, device=CPU) == data


@pytest.mark.parametrize("bit_len", [130, 200])
def test_xts_bit_len_matches_jax(bit_len):
    rng = np.random.default_rng(bit_len)
    keys, data = _rand(rng, 32), _rand(rng, (bit_len + 7) // 8)
    for tweak, sid in ((_rand(rng, 16), 0), (None, 2**40 + 17)):
        ct = aes.xts_encrypt(keys, tweak, data, sector_id=sid, bit_len=bit_len, device=CPU)
        assert ct == j_xts_encrypt(keys, tweak, data, sector_id=sid, bit_len=bit_len)
        back = aes.xts_decrypt(keys, tweak, ct, sector_id=sid, bit_len=bit_len, device=CPU)
        assert back == j_xts_decrypt(keys, tweak, ct, sector_id=sid, bit_len=bit_len)


@pytest.mark.parametrize("sector,klen", [(512, 64), (4096, 32), (528, 64), (528, 32)])
def test_xts_sectors_match_per_message(sector, klen):
    """The K6 stream path (512 B, 4 KiB) and the K2 fallback (528 B) against
    xts_encrypt per sector, integer ids up to 2^40 + 17 and a tweak block."""
    rng = np.random.default_rng(sector + klen)
    keys = _rand(rng, klen)
    sids = [3, 0, 2**40 + 17, _rand(rng, 16), 255]
    data = _rand(rng, len(sids) * sector)
    out = aes.xts_seal_sectors(keys, sids, data, sector, device=CPU)
    for i, sid in enumerate(sids):
        tweak, sector_id = (sid, 0) if isinstance(sid, bytes) else (None, sid)
        want = aes.xts_encrypt(keys, tweak, data[i * sector:(i + 1) * sector],
                               sector_id=sector_id, device=CPU)
        assert out[i * sector:(i + 1) * sector] == want, f"sector {i}"
    assert aes.xts_open_sectors(keys, sids, out, sector, device=CPU) == data


def _jax_state(keys, sids, data, sector):
    """JAX _prepare's key planes (as numpy), tweaks and sector blocks."""
    kp1, kp2, _, tweaks, blocks = jxb._prepare(keys, sids, data, sector, want_powers=False)
    kp1, kp2 = np.asarray(kp1), np.asarray(kp2)
    return kp1, kp2, tweaks, blocks


def test_sector_kernels_match_jax_on_carried_state():
    """xts_sectors_stream_kernel (8 sectors of 512 B, W = 8, sealing) and
    xts_sectors_kernel (2 sectors of 528 B, opening) against the JAX
    functions of the same names on one per-key state carried across with
    xts_state_from_jax; the port's own setup and its tweak blocks of integer
    and byte sector ids equal the JAX package's."""
    rng = np.random.default_rng(31)
    keys = _rand(rng, 64)
    sids = [int(v) for v in rng.integers(0, 2**48, 5)] + [0, 2**40 + 17, _rand(rng, 7)]
    data = _rand(rng, 8 * 512)
    kp1, kp2, jtw, _ = _jax_state(keys, sids, data, 512)
    assert np.array_equal(txb._prepare(keys, sids, data, 512, torch.device(CPU))[2].numpy(),
                          np.asarray(jtw))
    jpows = np.asarray(jxb._row_base_powers_t(1))
    tkp1, tkp2, tpows = txb.xts_state_from_jax(kp1, kp2, jpows, device=CPU)
    own = txb._xts_key_setup(keys, torch.device(CPU))
    assert torch.equal(own[0], tkp1) and torch.equal(own[1], tkp2)
    assert torch.equal(txb._row_base_powers_t(1, torch.device(CPU)), tpows)
    stream = host_stream(data, 0, 8)
    assert np.array_equal(stream, j_host_stream(data, 0, 8))
    with jax.disable_jit():
        want = jxb.xts_sectors_stream_kernel(kp1, kp2, jpows, jtw, jnp.asarray(stream))
    got = txb.xts_sectors_stream_kernel(tkp1, tkp2, tpows, torch.from_numpy(np.array(jtw)),
                                        _i32(stream))
    assert np.array_equal(_u32(got), np.asarray(want))

    data = data[: 2 * 528]
    kp1, kp2, jtw, jblocks = _jax_state(keys, sids[:2], data, 528)
    jpows = np.asarray(jxb._double_powers_t(33))
    tkp1, tkp2, tpows = txb.xts_state_from_jax(kp1, kp2, jpows, device=CPU)
    assert torch.equal(txb._double_powers_t(33, torch.device(CPU)), tpows)
    with jax.disable_jit():
        want = jxb.xts_sectors_kernel(kp1, kp2, jpows, jtw, jblocks, decrypt=True)
    got = txb.xts_sectors_kernel(tkp1, tkp2, tpows, torch.from_numpy(np.array(jtw)),
                                 torch.from_numpy(np.array(jblocks)), True)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_sector_ids_outside_128_bits_raise_data_length_error():
    """The JAX path crashes with IndexError on these ids; the port raises
    its own error (the JAX side is not called with them)."""
    keys, data = bytes(range(32)), bytes(512)
    for sid in (-1, 2**128, 2**130):
        with pytest.raises(DataLengthError):
            aes.xts_encrypt(keys, None, data, sector_id=sid, device=CPU)
        with pytest.raises(DataLengthError):
            aes.xts_seal_sectors(keys, [sid], data, 512, device=CPU)
    top = 2**128 - 1  # the largest id is the all-ones tweak block
    want = aes.xts_encrypt(keys, b"\xff" * 16, data, device=CPU)
    assert aes.xts_encrypt(keys, None, data, sector_id=top, device=CPU) == want
    assert aes.xts_seal_sectors(keys, [top], data, 512, device=CPU) == want


def test_xts_length_checks():
    keys = bytes(32)
    with pytest.raises(DataLengthError):
        aes.xts_encrypt(keys, bytes(16), b"0123456789", device=CPU)  # under one block
    with pytest.raises(DataLengthError):
        aes.xts_encrypt(keys, bytes(16), bytes(17), bit_len=129 + 8, device=CPU)
    for sector, n, ids in ((500, 1000, [0, 1]), (512, 1000, [0, 1]), (8192 + 16, 8208, [0]),
                           (512, 1024, [0])):  # the last: fewer ids than sectors
        with pytest.raises(DataLengthError):
            aes.xts_seal_sectors(keys, ids, bytes(n), sector, device=CPU)
    assert aes.xts_seal_sectors(keys, [], b"", 512, device=CPU) == b""
