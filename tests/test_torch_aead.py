"""Parity of the port's CCM and EAX layer and of the one-pass AEAD batches
with the JAX package, on the CPU: the per-message modes (ccm, eax with
EAX'), K11's plain version (ops/aead_kernels.aead_chain_fused on CPU
tensors) and the CCM, EAX and SIV batches (modes/bulk; the SIV batches run
K12's plain versions, tests/test_torch_siv_chain.py holds those to JAX).

Inputs come from numpy seeds and go through both packages; every output is
bytes, so every comparison is exact.  K11's plain version is held against the
JAX package's jnp twin of the kernel, the local body of
parallel/batch.aead_sharded_fn on a one-device mesh.  The JAX side runs
jitted at a few shapes (0.3-1 s a compile; the batches compile once per key
size, and the three modes' batches share one set of message shapes, so most
of their folds compile once); its Pallas kernels are never run (interpret
mode costs minutes).
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import micro_aes_tpu.modes.bulk as jbulk
import micro_aes_tpu.modes.ccm as jccm
import micro_aes_tpu.modes.eax as jeax
from micro_aes_tpu.core.bitslice import key_planes_packed as j_key_planes_packed
from micro_aes_tpu.core.keyschedule import expand_key as j_expand_key
from micro_aes_tpu.parallel.batch import aead_sharded_fn

import micro_aes_tpu_torch as aes
import micro_aes_tpu_torch.modes.bulk as tbulk
from micro_aes_tpu_torch import AuthenticationError
from micro_aes_tpu_torch.ops import aead_kernels as ak
from micro_aes_tpu_torch.ops.chain_kernels import chain_keys_from_jax
from micro_aes_tpu_torch.testing import kat

CPU = "cpu"
# (plaintext length, AAD length) pairs: empty, sub-block, whole, ragged
SHAPES = ((0, 0), (1, 3), (15, 40), (16, 0), (17, 3), (33, 40))


def _rand(rng, n) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _flip(blob: bytes, i: int) -> bytes:
    return blob[:i] + bytes([blob[i] ^ 1]) + blob[i + 1:]


@pytest.mark.parametrize("klen", [16, 24, 32])
def test_ccm_eax_per_message_match_jax(klen):
    """ccm_* (7- to 13-byte nonces, 16- and 8-byte tags) and eax_* against
    the JAX modes, two of SHAPES per key size (the JAX side compiles per
    block bucket and key size); a tampered tag raises AuthenticationError."""
    rng = np.random.default_rng(klen)
    key = _rand(rng, klen)
    first = (klen // 8 - 2) * 2
    for i, (n, alen) in enumerate(SHAPES[first: first + 2], first):
        nonce, aad, pt = _rand(rng, 7 + i), _rand(rng, alen), _rand(rng, n)
        tag_len = 8 if i % 2 else 16
        ct = aes.ccm_encrypt(key, nonce, aad, pt, len(nonce), tag_len, device=CPU)
        assert ct == jccm.ccm_encrypt(key, nonce, aad, pt, len(nonce), tag_len)
        assert aes.ccm_decrypt(key, nonce, aad, ct, len(nonce), tag_len, device=CPU) == pt
        ct = aes.eax_encrypt(key, nonce, aad, pt, device=CPU)
        assert ct == jeax.eax_encrypt(key, nonce, aad, pt)
        assert aes.eax_decrypt(key, nonce, aad, ct, device=CPU) == pt
    with pytest.raises(AuthenticationError):
        aes.ccm_decrypt(key, nonce, aad, _flip(ct, len(ct) - 1), len(nonce), tag_len,
                        device=CPU)
    with pytest.raises(AuthenticationError):
        aes.eax_decrypt(key, nonce, aad, _flip(ct, 0), device=CPU)


def test_eaxp_matches_jax_and_vectors():
    """EAX' against the JAX mode (the null-ciphertext rule, the N' bit
    clearing, 4-byte tags) and the IEEE 1703 vectors."""
    rng = np.random.default_rng(5)
    key = _rand(rng, 16)
    for n, alen in SHAPES[::2]:
        nd, pt = _rand(rng, alen), _rand(rng, n)
        ct = aes.eaxp_encrypt(key, nd, pt, device=CPU)
        assert ct == jeax.eaxp_encrypt(key, nd, pt)
        assert aes.eaxp_decrypt(key, nd, ct, device=CPU) == pt
    for name, key, nd, pt, blob in kat.EAXP_VECTORS:
        assert aes.eaxp_encrypt(key, nd, pt, device=CPU) == blob, name
        assert aes.eaxp_decrypt(key, nd, blob, device=CPU) == pt, name
    with pytest.raises(AuthenticationError):
        aes.eaxp_decrypt(key, nd, _flip(blob, len(blob) - 1), device=CPU)


def test_main_c_answers():
    """main.c's CCM128, EAX128 and EAXP128 (AES-128, the AAD as EAX' nonce
    data) and the SIV counter convention's bit clearing."""
    key, iv, aad, pt = kat.CIPHER_KEY[:16], kat.IVEC, kat.AAD, kat.PLAINTEXT
    assert aes.ccm_encrypt(key, iv[:11], aad, pt, device=CPU) == kat.CCM128
    assert aes.ccm_decrypt(key, iv[:11], aad, kat.CCM128, device=CPU) == pt
    assert aes.eax_encrypt(key, iv, aad, pt, device=CPU) == kat.EAX128
    assert aes.eax_decrypt(key, iv, aad, kat.EAX128, device=CPU) == pt
    assert aes.eaxp_encrypt(key, aad, pt, device=CPU) == kat.EAXP128
    from micro_aes_tpu_torch.modes.common import prepare_counter_base

    base, offset, endian = prepare_counter_base(torch.full((16,), 0xFF, dtype=torch.uint8),
                                                "siv")
    assert (offset, endian) == (0, "be")
    assert [i for i in range(16) if base[i] != 0xFF] == [8, 12]
    assert int(base[8]) == int(base[12]) == 0x7F


@pytest.mark.parametrize("kind,decrypt", [("ccm", False), ("ccm", True), ("eax", False),
                                          ("eax", True)])
def test_aead_chain_plain_matches_jax_twin(kind, decrypt):
    """K11 on the CPU (its two steps, K15's keystream pass and K13's MAC with
    the last-step constants, on their plain versions) and its monolithic
    plain version against the JAX twin of the kernel (the local body of
    aead_sharded_fn) at B = 32, nb = 3, AES-128: random nvalid in 0..nb,
    tail and lastadd, and counter bases that carry into byte 9."""
    rng = np.random.default_rng(60 + 2 * (kind == "eax") + decrypt)
    b, nb = 32, 3
    rks = np.stack([np.asarray(j_expand_key(_rand(rng, 16))) for _ in range(b)])

    def u8(*shape):
        return rng.integers(0, 256, shape, dtype=np.uint8)

    c0, init, tail, lastadd, blocks = u8(b, 16), u8(b, 16), u8(b, 16), u8(b, 16), u8(b, nb, 16)
    c0[0, 9:] = 0xFF        # the 56-bit window wraps; byte 8 stays
    c0[1, 12:] = 0xFF       # a carry into byte 11
    c0[2, 9:12] = 0xFF
    c0[2, 12:] = (0xFF, 0xFF, 0xFF, 0xFE)  # a carry through bytes 9..11
    nvalid = rng.integers(0, nb + 1, b).astype(np.int32)
    nvalid[:2] = (0, nb)
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    want_out, want_tag = aead_sharded_fn(mesh, kind, decrypt)(rks, c0, init, blocks, nvalid,
                                                              tail, lastadd)
    kpw = chain_keys_from_jax(j_key_planes_packed(rks), device=CPU)
    out, tag = ak.aead_chain_fused(kind, kpw, _t(c0), _t(init), _t(blocks), _t(nvalid),
                                   _t(tail), _t(lastadd), decrypt)
    assert np.array_equal(out.numpy(), np.asarray(want_out))
    assert np.array_equal(tag.numpy(), np.asarray(want_tag))
    mono = ak.aead_chain_fused_plain(kind, kpw, _t(c0), _t(init), _t(blocks), _t(nvalid),
                                     _t(tail), _t(lastadd), decrypt)
    assert torch.equal(mono[0], out) and torch.equal(mono[1], tag)
    assert ak.aead_chain_fused.launches == 0  # no kernel on the CPU


def test_ccm_prefix_batch_matches_jax():
    """The vectorized B0 + A-segment assembly against the JAX package's, on
    host arrays: nonces of 7..13 bytes, tags of 4..16 bytes, AADs from
    empty to one past 0xFEFF bytes (the 6-byte length field)."""
    rng = np.random.default_rng(70)
    alens = [0, 1, 13, 14, 0xFEFF, 0xFF00, 40, 3]
    iv0s = np.stack([jccm._iv0(_rand(rng, 7 + i % 7)) for i in range(len(alens))])
    aads = [rng.integers(0, 256, n, dtype=np.uint8) for n in alens]
    ptlens = [int(x) for x in rng.integers(0, 1 << 20, len(alens))]
    for tag_len in (4, 16):
        pb, nv1 = tbulk._ccm_prefix_batch(iv0s, aads, ptlens, tag_len)
        jpb, jnv1 = jbulk._ccm_prefix_batch(iv0s, aads, ptlens, tag_len)
        assert np.array_equal(pb, jpb) and np.array_equal(nv1, jnv1)
    assert np.array_equal(tbulk._tail_mask_np([0, 1, 15, 16, 17]),
                          jbulk._tail_mask_np([0, 1, 15, 16, 17]))


def _batch(rng, b, klens=(16, 32)):
    lens = [int(x) for x in rng.integers(0, 80, b)]
    lens[:5] = (0, 1, 15, 16, 17)
    keys = [_rand(rng, klens[i % len(klens)]) for i in range(b)]
    nonces = [_rand(rng, 11 + i % 3) for i in range(b)]
    aads = [_rand(rng, (0, 3, 40)[i % 3]) for i in range(b)]
    return keys, nonces, aads, [_rand(rng, n) for n in lens]


@pytest.mark.parametrize("mode", ["ccm", "eax"])
def test_aead_batch_seal_matches_jax(mode):
    """ccm_encrypt_batch / eax_encrypt_batch at 34 messages (AES-128 and -256
    mixed, empty, sub-block, whole and ragged messages, 11- to 13-byte
    nonces) against the JAX batches; an all-empty batch (the composed route)
    against the per-message modes, which the tests above hold to JAX."""
    rng = np.random.default_rng(80)  # one set of shapes: the modes share JAX compiles
    keys, nonces, aads, pts = _batch(rng, 34)
    tfn, jfn = ((tbulk.ccm_encrypt_batch, jbulk.ccm_encrypt_batch) if mode == "ccm"
                else (tbulk.eax_encrypt_batch, jbulk.eax_encrypt_batch))
    assert tfn(keys, nonces, aads, pts, device=CPU) == jfn(keys, nonces, aads, pts)
    one = aes.ccm_encrypt if mode == "ccm" else aes.eax_encrypt
    kw = {"nonce_len": 13} if mode == "ccm" else {}
    assert tfn(keys[:4], nonces[:4], aads[:4], [b""] * 4, device=CPU) == \
        [one(k, n, a, b"", device=CPU, **kw) for k, n, a in zip(keys[:4], nonces[:4], aads[:4])]


@pytest.mark.parametrize("mode", ["ccm", "eax"])
def test_aead_batch_open_matches_jax(mode):
    """ccm_decrypt_batch / eax_decrypt_batch on the same shapes: round trips,
    one tampered message comes back None, as in the JAX batches; the
    per-message modes agree on two samples."""
    rng = np.random.default_rng(80)
    keys, nonces, aads, pts = _batch(rng, 34)
    if mode == "ccm":
        seal, tfn, jfn = tbulk.ccm_encrypt_batch, tbulk.ccm_decrypt_batch, \
            jbulk.ccm_decrypt_batch
    else:
        seal, tfn, jfn = tbulk.eax_encrypt_batch, tbulk.eax_decrypt_batch, \
            jbulk.eax_decrypt_batch
    sealed = seal(keys, nonces, aads, pts, device=CPU)
    sealed[7] = _flip(sealed[7], 0)
    got = tfn(keys, nonces, aads, sealed, device=CPU)
    assert got == jfn(keys, nonces, aads, sealed)
    assert got == [None if i == 7 else p for i, p in enumerate(pts)]
    for i in (3, 20):
        one = (aes.ccm_encrypt(keys[i], nonces[i], aads[i], pts[i], len(nonces[i]), device=CPU)
               if mode == "ccm" else aes.eax_encrypt(keys[i], nonces[i], aads[i], pts[i],
                                                     device=CPU))
        assert one == sealed[i]


def test_siv_batch_seal_matches_jax():
    """siv_encrypt_batch on the shapes of the CCM and EAX batches (K1 || K2
    of 16 + 16 and 32 + 32 bytes mixed) against the JAX batch; an all-empty
    batch (S2V only) against the per-message mode."""
    keys, _, aads, pts = _batch(np.random.default_rng(80), 34, klens=(32, 64))
    assert tbulk.siv_encrypt_batch(keys, aads, pts, device=CPU) == \
        jbulk.siv_encrypt_batch(keys, aads, pts)
    assert tbulk.siv_encrypt_batch(keys[:4], aads[:4], [b""] * 4, device=CPU) == \
        [aes.siv_encrypt(k, a, b"", device=CPU) for k, a in zip(keys[:4], aads[:4])]


def test_siv_batch_open_matches_jax():
    """siv_decrypt_batch: round trips, a tampered IV and a tampered
    ciphertext come back None, as in the JAX batch; an all-empty batch."""
    keys, _, aads, pts = _batch(np.random.default_rng(80), 34, klens=(32, 64))
    sealed = tbulk.siv_encrypt_batch(keys, aads, pts, device=CPU)
    ivs, cts = [s[0] for s in sealed], [s[1] for s in sealed]
    ivs[6] = bytes([ivs[6][0] ^ 1]) + ivs[6][1:]
    cts[9] = bytes([cts[9][0] ^ 1]) + cts[9][1:]
    got = tbulk.siv_decrypt_batch(keys, ivs, aads, cts, device=CPU)
    assert got == jbulk.siv_decrypt_batch(keys, ivs, aads, cts)
    assert got == [None if i in (6, 9) else p for i, p in enumerate(pts)]
    assert aes.siv_decrypt(keys[3], ivs[3], aads[3], cts[3], device=CPU) == pts[3]
    empty = tbulk.siv_encrypt_batch(keys[:4], aads[:4], [b""] * 4, device=CPU)
    assert tbulk.siv_decrypt_batch(keys[:4], [e[0] for e in empty], aads[:4], [b""] * 4,
                                   device=CPU) == [b""] * 4
