"""Parity of the port's AES-SIV layer with the JAX package, on the CPU: the
per-message mode (modes/siv), K12's plain versions (ops/aead_kernels.
siv_seal_chain_fused and siv_open_chain_fused on CPU tensors) and S2V's
last-block constants (modes/bulk; the SIV batches are held to JAX in
tests/test_torch_aead.py).

Inputs come from numpy seeds and go through both packages; every output is
bytes, so every comparison is exact.  K12's seal is held against the JAX
package's jnp twin of the kernel, the local body of parallel/batch.
siv_sharded_fn on a one-device mesh; the open direction has no twin and is
held by round trips and a tampered block.  The JAX side runs jitted at a few
shapes; its Pallas kernels are never run.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import micro_aes_tpu.modes.bulk as jbulk
import micro_aes_tpu.modes.siv as jsiv
from micro_aes_tpu.core.bitslice import key_planes_packed as j_key_planes_packed
from micro_aes_tpu.core.keyschedule import expand_key as j_expand_key
from micro_aes_tpu.parallel.batch import siv_sharded_fn

import micro_aes_tpu_torch as aes
import micro_aes_tpu_torch.modes.bulk as tbulk
from micro_aes_tpu_torch import AuthenticationError
from micro_aes_tpu_torch.ops import aead_kernels as ak
from micro_aes_tpu_torch.ops.chain_kernels import chain_keys_from_jax
from micro_aes_tpu_torch.testing import kat

CPU = "cpu"
SHAPES = ((0, 0), (1, 3), (15, 40), (16, 0), (17, 3), (33, 40))


def _rand(rng, n) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("klen", [32, 48, 64])
def test_siv_per_message_matches_jax(klen):
    """siv_encrypt / siv_decrypt (K1 || K2 of 16, 24 and 32 bytes each)
    against the JAX mode, two of SHAPES per key size; a tampered IV or
    ciphertext raises AuthenticationError."""
    rng = np.random.default_rng(klen)
    keys = _rand(rng, klen)
    first = (klen // 16 - 2) * 2
    for n, alen in SHAPES[first: first + 2]:
        aad, pt = _rand(rng, alen), _rand(rng, n)
        iv, ct = aes.siv_encrypt(keys, aad, pt, device=CPU)
        assert (iv, ct) == jsiv.siv_encrypt(keys, aad, pt)
        assert aes.siv_decrypt(keys, iv, aad, ct, device=CPU) == pt
    with pytest.raises(AuthenticationError):
        aes.siv_decrypt(keys, bytes([iv[0] ^ 1]) + iv[1:], aad, ct, device=CPU)
    with pytest.raises(AuthenticationError):
        aes.siv_decrypt(keys, iv, aad, bytes([ct[-1] ^ 0x80]) + ct[:-1], device=CPU)


def test_siv_vectors():
    """main.c's SIV128 (iv || ct under CIPHER_KEY as K1 || K2), RFC 5297 A.1
    and the no-AAD vector of tests/test_modes_aead.py (miscreant's)."""
    iv, ct = aes.siv_encrypt(kat.MAIN_KEY, kat.MAIN_AAD, kat.MAIN_PLAINTEXT, device=CPU)
    assert iv + ct == kat.SIV128
    keys, aad, pt, blob = kat.SIV_RFC5297
    iv, ct = aes.siv_encrypt(keys, aad, pt, device=CPU)
    assert iv + ct == blob
    assert aes.siv_decrypt(keys, iv, aad, ct, device=CPU) == pt
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    iv, ct = aes.siv_encrypt(keys, b"", pt, device=CPU)
    assert (iv + ct).hex() == ("f304f912863e303d5b540e5057c7010c"
                               "942ffaf45b0e5ca5fb9a56a5263bb065")


def test_siv_chain_plain_matches_jax_twin():
    """K12's seal on the CPU (its two steps, K13's MAC with the last-step
    constants and K15's keystream pass, on their plain versions) and its
    monolithic plain version against the JAX twin of the kernel (the local
    body of siv_sharded_fn) at B = 32, nb = 3, AES-128 with random nvalid in
    1..nb and random S2V constants; the open direction inverts it (s2v ==
    iv) as its monolithic plain version does, and a tampered block changes
    only its message's s2v."""
    rng = np.random.default_rng(90)
    b, nb = 32, 3
    rks1, rks2 = (np.stack([np.asarray(j_expand_key(_rand(rng, 16))) for _ in range(b)])
                  for _ in range(2))

    def u8(*shape):
        return rng.integers(0, 256, shape, dtype=np.uint8)

    init, tail, lastadd, prevadd, blocks = u8(b, 16), u8(b, 16), u8(b, 16), u8(b, 16), \
        u8(b, nb, 16)
    nvalid = rng.integers(1, nb + 1, b).astype(np.int32)
    nvalid[:2] = (1, nb)
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    want_ct, want_iv = siv_sharded_fn(mesh)(rks1, rks2, init, blocks, nvalid, tail, lastadd,
                                            prevadd)
    kpm = chain_keys_from_jax(j_key_planes_packed(rks1), device=CPU)
    kpc = chain_keys_from_jax(j_key_planes_packed(rks2), device=CPU)
    consts = (_t(nvalid), _t(tail), _t(lastadd), _t(prevadd))
    ct, iv = ak.siv_seal_chain_fused(kpm, kpc, _t(init), _t(blocks), *consts)
    assert np.array_equal(ct.numpy(), np.asarray(want_ct))
    assert np.array_equal(iv.numpy(), np.asarray(want_iv))
    mono = ak.siv_seal_chain_fused_plain(kpm, kpc, _t(init), _t(blocks), *consts)
    assert torch.equal(mono[0], ct) and torch.equal(mono[1], iv)
    bases = ak._siv_bases(iv)
    assert torch.equal(bases[:, [8, 12]], iv[:, [8, 12]] & 0x7F)
    pt, s2v = ak.siv_open_chain_fused(kpm, kpc, bases, _t(init), ct, *consts)
    assert torch.equal(pt, _t(blocks)) and torch.equal(s2v, iv)
    mono = ak.siv_open_chain_fused_plain(kpm, kpc, bases, _t(init), ct, *consts)
    assert torch.equal(mono[0], pt) and torch.equal(mono[1], s2v)
    bad = ct.clone()
    bad[5, 0, 0] ^= 1
    _, s2v_bad = ak.siv_open_chain_fused(kpm, kpc, bases, _t(init), bad, *consts)
    assert not torch.equal(s2v_bad[5], iv[5])
    assert torch.equal(s2v_bad[torch.arange(b) != 5], iv[torch.arange(b) != 5])
    assert ak.siv_seal_chain_fused.launches == ak.siv_open_chain_fused.launches == 0


def test_siv_s2v_consts_match_jax():
    """S2V's last-block constants (tail, lastadd, prevadd, nvalid) against the
    JAX package's on host arrays, for lengths around the block edges."""
    rng = np.random.default_rng(91)
    lens = [0, 1, 15, 16, 17, 31, 32, 33, 47, 100]
    d, q, y = (rng.integers(0, 256, (len(lens), 16), dtype=np.uint8) for _ in range(3))
    for got, want in zip(tbulk._siv_s2v_consts(d, q, y, lens),
                         jbulk._siv_s2v_consts(d, q, y, lens)):
        assert np.array_equal(got, want)
