"""The port's per-message ECB, CBC, CFB, OFB, CTR and CMAC (micro_aes_tpu_torch
modes/ecb, cbc, cfb, ofb, ctr, cmac and the padding and CMAC machinery of
modes/common) against the reference main.c known answers and the JAX
package, on the CPU.

The serial parts (CBC/CFB encrypt, the OFB keystream, the CBC-MAC) run K13's
plain version as a batch of one message.  Every comparison is bit-exact.
The JAX per-message modes run jitted, compiled once per block bucket, so the
random messages share the buckets of the known answers' 57 bytes.
"""
import numpy as np
import pytest

import micro_aes_tpu.modes.common as jcommon
from micro_aes_tpu.modes.cbc import cbc_decrypt as j_cbc_decrypt
from micro_aes_tpu.modes.cbc import cbc_encrypt as j_cbc_encrypt
from micro_aes_tpu.modes.cfb import cfb_encrypt as j_cfb_encrypt
from micro_aes_tpu.modes.cmac import cmac as j_cmac
from micro_aes_tpu.modes.ecb import ecb_encrypt as j_ecb_encrypt
from micro_aes_tpu.modes.ofb import ofb_encrypt as j_ofb_encrypt

import micro_aes_tpu_torch as aes
import micro_aes_tpu_torch.modes.common as tcommon
from micro_aes_tpu_torch import DataLengthError, DecryptionError
from micro_aes_tpu_torch.ops import chain_kernels
from micro_aes_tpu_torch.testing import kat

CPU = "cpu"
KEY128 = kat.CIPHER_KEY[:16]
IV = kat.IVEC
PT = kat.PLAINTEXT  # 57 bytes


def _rand(rng, n) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def test_ecb_known_answers():
    assert aes.ecb_encrypt(KEY128, PT, device=CPU) == kat.ECB128
    assert aes.ecb_decrypt(KEY128, kat.ECB128, device=CPU)[: len(PT)] == PT
    key192 = kat.CIPHER_KEY[:24]
    assert aes.ecb_encrypt(key192, PT, padding=tcommon.PAD_PKCS7, device=CPU) == kat.ECB192
    with pytest.raises(DecryptionError):
        aes.ecb_decrypt(KEY128, bytes(17), device=CPU)


def test_cbc_known_answers_and_errors():
    assert aes.cbc_encrypt(KEY128, IV, PT, device=CPU) == kat.CBC128_CTS
    assert aes.cbc_decrypt(KEY128, IV, kat.CBC128_CTS, device=CPU) == PT
    assert aes.cbc_encrypt(KEY128, IV, PT, cts=False, device=CPU) == kat.CBC128_PAD0
    assert aes.cbc_decrypt(KEY128, IV, kat.CBC128_PAD0, cts=False, device=CPU)[: len(PT)] == PT
    with pytest.raises(DataLengthError):
        aes.cbc_encrypt(KEY128, IV, b"short", device=CPU)
    with pytest.raises(DataLengthError):
        aes.cbc_decrypt(KEY128, IV, bytes(20), cts=False, device=CPU)
    whole = bytes(range(48))  # CS3 swaps the last two whole blocks
    assert aes.cbc_decrypt(KEY128, IV, aes.cbc_encrypt(KEY128, IV, whole, device=CPU),
                           device=CPU) == whole


def test_cfb_ofb_ctr_cmac_known_answers():
    assert aes.cfb_encrypt(KEY128, IV, PT, device=CPU) == kat.CFB128
    assert aes.cfb_decrypt(KEY128, IV, kat.CFB128, device=CPU) == PT
    assert aes.ofb_encrypt(KEY128, IV, PT, device=CPU) == kat.OFB128
    assert aes.ofb_decrypt(KEY128, IV, kat.OFB128, device=CPU) == PT
    assert aes.ctr_encrypt(KEY128, IV, PT, device=CPU) == kat.CTR128
    assert aes.cmac(KEY128, PT, device=CPU) == kat.CMAC128
    for fn in (chain_kernels.chain_packed_fused, chain_kernels.ofb_packed_fused,
               chain_kernels.cbcmac_packed_fused):
        assert fn.launches == 0  # the CPU runs the plain versions


def test_modes_match_jax_on_random_messages():
    """Each mode under an AES-256 key at 49..63 bytes (the known answers'
    block bucket), and empty and one-byte messages, against the JAX modes
    (AES-192 chains and whole single blocks are held against JAX in
    test_torch_chain)."""
    rng = np.random.default_rng(32)
    key, iv = _rand(rng, 32), _rand(rng, 16)
    for n in (int(rng.integers(49, 64)), 0, 1):
        pt = _rand(rng, n)
        if n >= 16:
            ct = aes.cbc_encrypt(key, iv, pt, device=CPU)
            assert ct == j_cbc_encrypt(key, iv, pt)
            assert aes.cbc_decrypt(key, iv, ct, device=CPU) == j_cbc_decrypt(key, iv, ct) == pt
        for padding in (tcommon.PAD_ZERO, tcommon.PAD_PKCS7, tcommon.PAD_ISO7816):
            ct = aes.cbc_encrypt(key, iv, pt, cts=False, padding=padding, device=CPU)
            assert ct == j_cbc_encrypt(key, iv, pt, cts=False, padding=padding)
        pkcs7 = tcommon.PAD_PKCS7
        assert aes.ecb_encrypt(key, pt, pkcs7, device=CPU) == j_ecb_encrypt(key, pt, pkcs7)
        ct = aes.cfb_encrypt(key, iv, pt, device=CPU)
        assert ct == j_cfb_encrypt(key, iv, pt)
        assert aes.cfb_decrypt(key, iv, ct, device=CPU) == pt
        assert aes.ofb_encrypt(key, iv, pt, device=CPU) == j_ofb_encrypt(key, iv, pt)
        assert aes.cmac(key, pt, device=CPU) == j_cmac(key, pt)


def test_padding_and_cmac_machinery_match_jax():
    rng = np.random.default_rng(3)
    for n in (0, 1, 15, 16, 17):
        data = rng.integers(0, 256, n, dtype=np.uint8)
        for padding in (tcommon.PAD_ZERO, tcommon.PAD_PKCS7, tcommon.PAD_ISO7816):
            got, extra = tcommon.pad_message(data, padding)
            want, jextra = jcommon.pad_message(data, padding)
            assert np.array_equal(got, want) and extra == jextra
    tcommon.check_block_multiple(32)
    with pytest.raises(DataLengthError):
        tcommon.check_block_multiple(33)
    key = _rand(rng, 16)
    for le in (False, True):
        got = tcommon.cmac_subkeys(key, CPU, le)
        want = jcommon.cmac_subkeys(key, le)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        assert not got[0].flags.writeable
    init = rng.integers(0, 256, 16, dtype=np.uint8)
    for n in (0, 20, 32):
        data = _rand(rng, n)
        assert np.array_equal(tcommon.cmac_digest(key, data, CPU, init=init),
                              jcommon.cmac_digest(key, data, init=init))
    blocks = rng.integers(0, 256, (3, 16), dtype=np.uint8)
    assert np.array_equal(tcommon.cbcmac_np(key, init, blocks, CPU),
                          jcommon.cbcmac_np(key, init, blocks))
    assert np.array_equal(tcommon.cbcmac_np(key, init, blocks[:0], CPU), init)
