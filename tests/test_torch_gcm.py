"""Parity of the port's per-message AES-GCM and CTR (micro_aes_tpu_torch
modes/gcm, modes/ctr) and of the pieces under them (key expansion of a
batch, plane packing, lane-packed keys, counter blocks, GHASH folds) with
the JAX package, on the CPU.

Inputs come from numpy seeds and go through both packages; every
comparison is bit-exact (all outputs are integers).  The JAX side runs
jitted: its per-message path compiles a few shape buckets once.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import micro_aes_tpu.core.bitslice as jbs
from micro_aes_tpu.core.keyschedule import expand_keys_batch as j_expand_keys_batch
from micro_aes_tpu.modes.ctr import ctr_encrypt as j_ctr_encrypt
from micro_aes_tpu.modes.gcm import gcm_encrypt as j_gcm_encrypt
from micro_aes_tpu.ops.counter import counter_blocks as j_counter_blocks
from micro_aes_tpu.ops.gf128 import ghash_matrix as j_ghash_matrix
from micro_aes_tpu.ops.mac import ghash_fold as j_ghash_fold
from micro_aes_tpu.ops.mac import ghash_fold_batch as j_ghash_fold_batch

import micro_aes_tpu_torch as aes
import micro_aes_tpu_torch.core.bitslice as tbs
from micro_aes_tpu_torch.core.keyschedule import expand_keys_batch
from micro_aes_tpu_torch.ops.counter import counter_blocks
from micro_aes_tpu_torch.ops.gf128 import ghash_matrix
from micro_aes_tpu_torch.ops.mac import ghash_fold, ghash_fold_batch
from micro_aes_tpu_torch.testing.kat import GCM_SPEC_AEAD_VECTORS, GCM_SPEC_VECTORS

CPU = "cpu"


def _rand(rng, n) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _u8(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint8))


@pytest.mark.parametrize("klen", (16, 24, 32))
def test_expand_keys_batch_matches_jax(klen):
    keys = np.random.default_rng(klen).integers(0, 256, (40, klen), dtype=np.uint8)
    np.testing.assert_array_equal(expand_keys_batch(keys), j_expand_keys_batch(keys))


def test_plane_packing_and_lane_keys_match_jax():
    rng = np.random.default_rng(1)
    blocks = rng.integers(0, 256, (96, 16), dtype=np.uint8)
    planes = tbs.pack_planes(_u8(blocks))
    np.testing.assert_array_equal(planes.numpy().view(np.uint32),
                                  np.asarray(jbs.pack_planes(jnp.asarray(blocks))))
    np.testing.assert_array_equal(tbs.unpack_planes(planes, 90).numpy(), blocks[:90])
    rks = j_expand_keys_batch(rng.integers(0, 256, (64, 16), dtype=np.uint8))
    kpw = jbs.key_planes_packed(rks)
    np.testing.assert_array_equal(tbs.key_planes_packed(rks), kpw)
    np.testing.assert_array_equal(
        tbs.key_planes_batch(_u8(rks)).numpy().view(np.uint32), jbs.key_planes_batch(rks))
    got = tbs.encrypt_planes_multikey(torch.from_numpy(kpw.view(np.int32)),
                                      tbs.pack_planes(_u8(blocks[:64])))
    want = jbs.encrypt_planes_multikey(jnp.asarray(kpw), jbs.pack_planes(jnp.asarray(blocks[:64])))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


@pytest.mark.parametrize("tail", ["random", "carry"])
def test_counter_blocks_match_jax(tail):
    base = np.random.default_rng(2).integers(0, 256, 16, dtype=np.uint8)
    if tail == "carry":  # the low word wraps and carries across bytes 9..11
        base[9:16] = [0x12, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xF0]
    for offset in (0, 1, 7):
        np.testing.assert_array_equal(
            counter_blocks(_u8(base), 40, offset).numpy(),
            np.asarray(j_counter_blocks(jnp.asarray(base), 40, offset, "be")))


def test_ghash_folds_match_jax():
    rng = np.random.default_rng(3)
    b, m = 6, 9
    h = rng.integers(0, 256, (b, 16), dtype=np.uint8)
    init = rng.integers(0, 256, (b, 16), dtype=np.uint8)
    blocks = rng.integers(0, 256, (b, m, 16), dtype=np.uint8)
    nvalid = np.array([0, 1, 4, 9, 9, 3], np.int32)
    got = ghash_fold_batch(_u8(h), _u8(init), _u8(blocks), nvalid)
    want = j_ghash_fold_batch(jnp.asarray(h), jnp.asarray(init), jnp.asarray(blocks),
                              jnp.asarray(nvalid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    m_h = ghash_matrix(h[0])
    np.testing.assert_array_equal(m_h, np.asarray(j_ghash_matrix(h[0])))
    got1 = ghash_fold(_u8(m_h), _u8(init[0]), _u8(blocks[0]), 7)
    want1 = j_ghash_fold(jnp.asarray(m_h), jnp.asarray(init[0]), jnp.asarray(blocks[0]),
                         jnp.int32(7))
    np.testing.assert_array_equal(got1.numpy(), np.asarray(want1))


def test_gcm_spec_vectors():
    for name, key, iv, pt, ct, tag in GCM_SPEC_VECTORS:
        assert aes.gcm_encrypt(key, iv, b"", pt, device=CPU) == ct + tag, name
        assert aes.gcm_decrypt(key, iv, b"", ct + tag, device=CPU) == pt, name
    for name, key, iv, aad, pt, ct, tag in GCM_SPEC_AEAD_VECTORS:
        assert aes.gcm_encrypt(key, iv, aad, pt, device=CPU) == ct + tag, name
        assert aes.gcm_decrypt(key, iv, aad, ct + tag, device=CPU) == pt, name


@pytest.mark.parametrize("nonce_len", (12, 8, 60))
@pytest.mark.parametrize("klen", (16, 24, 32))
def test_gcm_encrypt_decrypt_match_jax(klen, nonce_len):
    rng = np.random.default_rng(10 * klen + nonce_len)
    key, nonce = _rand(rng, klen), _rand(rng, nonce_len)
    for n, alen, tag_len in ((0, 0, 16), (1, 13, 16), (31, 20, 12), (100, 0, 4), (16, 16, 16)):
        pt, aad = _rand(rng, n), _rand(rng, alen)
        blob = aes.gcm_encrypt(key, nonce, aad, pt, tag_len, device=CPU)
        assert blob == j_gcm_encrypt(key, nonce, aad, pt, tag_len), (n, alen, tag_len)
        assert aes.gcm_decrypt(key, nonce, aad, blob, tag_len, device=CPU) == pt
        bad = blob[:-1] + bytes([blob[-1] ^ 0x80])
        with pytest.raises(aes.AuthenticationError):
            aes.gcm_decrypt(key, nonce, aad, bad, tag_len, device=CPU)
        if n:
            bad = bytes([blob[0] ^ 1]) + blob[1:]
            with pytest.raises(aes.AuthenticationError):
                aes.gcm_decrypt(key, nonce, aad, bad, tag_len, device=CPU)


@pytest.mark.parametrize("preset", (False, True))
def test_ctr_matches_jax(preset):
    rng = np.random.default_rng(20 + preset)
    key = _rand(rng, 32)
    iv = bytearray(_rand(rng, 16))
    iv[12:16] = b"\xff\xff\xff\xfe"  # the low word wraps inside the message
    for n in (0, 5, 16, 77):
        pt = _rand(rng, n)
        ct = aes.ctr_encrypt(key, bytes(iv), pt, preset, device=CPU)
        assert ct == j_ctr_encrypt(key, bytes(iv), pt, preset)
        assert aes.ctr_decrypt(key, bytes(iv), ct, preset, device=CPU) == pt
