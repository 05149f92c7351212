"""Parity of the port's OCB (micro_aes_tpu_torch: modes/ocb, the K7 plain
version of ops/xex_kernels and modes/ocb_bulk) with the JAX package, on the
CPU.

Inputs come from numpy seeds and go through both packages; every output is
an integer array or bytes and every comparison is bit-exact.  The JAX kernel
twin and bulk engine run eagerly under jax.disable_jit at a few stream rows
(an XLA compile of the bulk engine costs 15 s per shape); the JAX
per-message path runs jitted on a few shape buckets.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import micro_aes_tpu.modes.ocb_bulk as job
import micro_aes_tpu.ops.pallas_seal as jps
from micro_aes_tpu.modes.ocb import _subkeys as j_subkeys
from micro_aes_tpu.modes.ocb import ocb_encrypt as j_ocb_encrypt

import micro_aes_tpu_torch as aes
import micro_aes_tpu_torch.modes.ocb_bulk as tob
from micro_aes_tpu_torch import AuthenticationError, DataLengthError
from micro_aes_tpu_torch.ops import xex_kernels
from micro_aes_tpu_torch.testing.kat import OCB_VECTORS

CPU = "cpu"


def _rand(rng, n) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.uint32).view(np.int32).copy())


@pytest.mark.parametrize("klen,decrypt", [(16, False), (32, True)])
def test_ocb_plain_version_matches_jax_twin(klen, decrypt):
    """K7's plain version vs ocb_fused_jnp at W = 8: random lane words for
    D_0 and 11 rows of L_b, of which nbits = 9 are read."""
    rng = np.random.default_rng(60 + klen)
    kp, _ = aes.gcm_key_setup(_rand(rng, klen), device=CPU)
    kpf = kp.numpy().view(np.uint32).reshape(-1, 1)
    d0l = rng.integers(0, 2**32, (1, 128), dtype=np.uint32)
    lbl = rng.integers(0, 2**32, (11, 128), dtype=np.uint32)
    x = rng.integers(0, 2**32, (8, 128), dtype=np.uint32)
    with jax.disable_jit():
        want = jps.ocb_fused_jnp(jnp.asarray(kpf), jnp.asarray(d0l), jnp.asarray(lbl),
                                 jnp.asarray(x), 9, decrypt=decrypt)
    got = xex_kernels.ocb_fused(_i32(kpf), _i32(d0l), _i32(lbl), _i32(x), 9, decrypt)
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))


@pytest.mark.parametrize("nbits", (1, 5, 6, 12))
def test_ocb_offsets_match_jax_across_blocks_of_rows(nbits):
    """The offset stream K7 builds (its plain version, ops/xex_kernels.
    ocb_offsets) vs JAX's _ocb_offsets at W = 300: rows across the kernel's
    128-row blocks, r + 1 a power of two at rows 127 and 255, random lane
    words for D_0 and L_b, bit for bit (jnp ops, run eagerly)."""
    rng = np.random.default_rng(90 + nbits)
    d0l = rng.integers(0, 2**32, (1, 128), dtype=np.uint32)
    lbl = rng.integers(0, 2**32, (nbits, 128), dtype=np.uint32)
    with jax.disable_jit():
        want = jps._ocb_offsets(nbits, jnp.uint32(0), 300, jnp.asarray(d0l), jnp.asarray(lbl))
    got = xex_kernels.ocb_offsets(_i32(d0l), _i32(lbl), 300, nbits)
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))


@pytest.mark.parametrize("vector", OCB_VECTORS, ids=lambda v: v[0])
def test_ocb_vectors(vector):
    name, key, nonce, aad, pt, blob = vector
    assert j_ocb_encrypt(key, nonce, aad, pt) == blob  # the copy matches JAX's
    for seal, open_ in ((aes.ocb_encrypt, aes.ocb_decrypt), (aes.ocb_seal, aes.ocb_open)):
        assert seal(key, nonce, aad, pt, device=CPU) == blob
        assert open_(key, nonce, aad, blob, device=CPU) == pt


@pytest.mark.parametrize("nonce_len,tag_len,aad_len,pt_len",
                         [(1, 16, 0, 0), (12, 16, 0, 37), (15, 8, 16, 33), (12, 8, 7, 16),
                          (12, 16, 40, 517), (15, 16, 1, 32 * 16 * 9 + 5)])
def test_ocb_per_message_and_bulk_match_jax(nonce_len, tag_len, aad_len, pt_len):
    """ocb_encrypt/ocb_decrypt and ocb_seal/ocb_open against JAX
    ocb_encrypt: nonces of 1, 12 and 15 bytes, 8- and 16-byte tags, empty
    and ragged AAD and messages (the last spans 9 stream rows); a flipped
    tag bit is refused with nothing returned."""
    rng = np.random.default_rng(nonce_len * 1000 + pt_len)
    key, nonce = _rand(rng, 16), _rand(rng, nonce_len)
    aad, pt = _rand(rng, aad_len), _rand(rng, pt_len)
    blob = j_ocb_encrypt(key, nonce, aad, pt, tag_len)
    assert aes.ocb_encrypt(key, nonce, aad, pt, tag_len, device=CPU) == blob
    assert aes.ocb_seal(key, nonce, aad, pt, tag_len, device=CPU) == blob
    assert aes.ocb_decrypt(key, nonce, aad, blob, tag_len, device=CPU) == pt
    assert aes.ocb_open(key, nonce, aad, blob, tag_len, device=CPU) == pt
    bad = bytearray(blob)
    bad[-1] ^= 0x04
    for open_ in (aes.ocb_decrypt, aes.ocb_open):
        with pytest.raises(AuthenticationError):
            open_(key, nonce, aad, bytes(bad), tag_len, device=CPU)


def test_ocb_bulk_matches_jax_bulk_on_carried_state():
    """The JAX bulk ocb_seal (eager) against the port's, AES-256, 4 stream
    rows and a ragged tail; the port's per-key state equals JAX's carried
    across with ocb_state_from_jax (K7's lane-word table included)."""
    rng = np.random.default_rng(8)
    key, nonce, aad, pt = _rand(rng, 32), _rand(rng, 12), _rand(rng, 21), _rand(rng, 16 * 100 + 9)
    with jax.disable_jit():
        want = job.ocb_seal(key, nonce, aad, pt)
    assert aes.ocb_seal(key, nonce, aad, pt, device=CPU) == want
    assert aes.ocb_open(key, nonce, aad, want, device=CPU) == pt
    l_star, l_dollar, ls = j_subkeys(key)
    state = tob.ocb_state_from_jax(np.asarray(job._ocb_key_setup(key)), l_star, l_dollar, ls,
                                   device=CPU)
    own = tob._ocb_key_setup(key, torch.device(CPU))
    assert torch.equal(own[0], state[0]) and torch.equal(own[4], state[4])
    for a, b in zip(own[1:4], state[1:4]):
        assert np.array_equal(a, b)
    assert np.array_equal(state[4].numpy().view(np.uint32),
                          np.stack([job._lane_words(ls[b]) for b in range(len(ls))]))


def test_ocb_nonce_length_checks():
    key = bytes(16)
    for nonce in (b"", bytes(16)):
        for fn, data in ((aes.ocb_encrypt, b"abc"), (aes.ocb_seal, b"abc"),
                         (aes.ocb_decrypt, bytes(20)), (aes.ocb_open, bytes(20))):
            with pytest.raises(DataLengthError):
                fn(key, nonce, b"", data, device=CPU)


def test_purge_reaches_the_xts_and_ocb_caches():
    from micro_aes_tpu_torch.modes import ocb, xts_bulk
    from micro_aes_tpu_torch.utils.keycache import registered_key_caches

    aes.ocb_seal(bytes(16), bytes(12), b"a", bytes(40), device=CPU)
    aes.xts_seal_sectors(bytes(32), [1], bytes(512), 512, device=CPU)
    caches = (tob._ocb_key_setup, ocb._subkeys, xts_bulk._xts_key_setup)
    assert all(c in registered_key_caches() and c.cache_info().currsize for c in caches)
    aes.purge_key_caches()
    assert all(c.cache_info().currsize == 0 for c in caches)
