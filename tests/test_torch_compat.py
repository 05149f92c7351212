"""The port's C-style compat surface (micro_aes_tpu_torch.compat) and its
top-level API, against the JAX package's, on the CPU: the five cases of the
JAX package's compat tests, the result codes, the names and positional
parameters of every `AES_*` function, a round trip of each on the main.c
vectors (with a tampered tag or a bad length for the fallible ones), and
the package's public names.
"""
import inspect

import pytest
import torch

import micro_aes_tpu
import micro_aes_tpu.modes
from micro_aes_tpu import compat as jcompat

import micro_aes_tpu_torch as aes
import micro_aes_tpu_torch.modes
from micro_aes_tpu_torch import compat
from micro_aes_tpu_torch.testing import kat

CPU = "cpu"
KEY = kat.CIPHER_KEY[:16]
IV = kat.IVEC
AAD = kat.AAD
PT = kat.PLAINTEXT
OK = compat.M_RESULT_SUCCESS


def _tamper(blob: bytes) -> bytes:
    return blob[:-1] + bytes([blob[-1] ^ 1])


# -- the JAX package's compat cases, through the port -------------------------

def test_error_code_values():
    # micro_aes.h:469-476 (0x1L is the long literal 1)
    assert compat.M_RESULT_SUCCESS == 0
    assert compat.M_ENCRYPTION_ERROR == 0x1E
    assert compat.M_DECRYPTION_ERROR == 0x1D
    assert compat.M_AUTHENTICATION_ERROR == 0x1A
    assert compat.M_DATALENGTH_ERROR == 1


def test_compat_gcm_roundtrip_and_codes():
    ct = compat.AES_GCM_encrypt(KEY, IV[:12], AAD, PT, device=CPU)
    assert ct == kat.GCM128
    assert compat.AES_GCM_decrypt(KEY, IV[:12], AAD, ct, device=CPU) == (OK, PT)
    assert compat.AES_GCM_decrypt(KEY, IV[:12], AAD, _tamper(ct), device=CPU) == \
        (compat.M_AUTHENTICATION_ERROR, b"")


def test_compat_length_errors():
    code, _ = compat.AES_CBC_encrypt(KEY, IV, b"x", device=CPU)
    assert code == compat.M_DATALENGTH_ERROR
    code, _ = compat.AES_KEY_wrap(KEY, b"1234567", device=CPU)
    assert code == compat.M_DATALENGTH_ERROR


def test_compat_cipher_and_macs():
    assert compat.AES_Cipher(kat.FIPS_KEY128, "E", kat.FIPS_PT, device=CPU) == kat.FIPS_CT128
    assert compat.AES_CMAC(KEY, PT, device=CPU) == kat.CMAC128
    assert compat.AES_Poly1305(kat.CIPHER_KEY, IV, PT, device=CPU) == kat.POLY1305_128


def test_compat_fpe():
    assert compat.AES_FPE_encrypt(KEY, AAD, kat.FPE_PLAIN, device=CPU) == (OK, kat.FPE_FF1_CIPHER)
    code, _ = compat.AES_FPE_encrypt(KEY, b"", "123", device=CPU)
    assert code == compat.M_ENCRYPTION_ERROR


# -- the surface against the JAX package's ------------------------------------

@pytest.mark.parametrize("name", [n for n in dir(jcompat) if n.startswith("M_")])
def test_result_codes_match_jax(name):
    assert getattr(compat, name) == getattr(jcompat, name)


C_NAMES = sorted(n for n, f in vars(jcompat).items()
                 if callable(f) and (n.startswith("AES_") or n.startswith("GCM_SIV_")))


def _positional(fn) -> list[str]:
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind is not inspect.Parameter.KEYWORD_ONLY]


@pytest.mark.parametrize("name", C_NAMES)
def test_c_names_and_parameters_match_jax(name):
    fn = getattr(compat, name)
    assert _positional(fn) == _positional(getattr(jcompat, name))
    device = inspect.signature(fn).parameters["device"]
    assert device.kind is inspect.Parameter.KEYWORD_ONLY and device.default == "cuda"


def test_public_names_cover_jax():
    assert set(micro_aes_tpu.__all__) <= set(aes.__all__)
    assert set(micro_aes_tpu.modes.__all__) <= set(micro_aes_tpu_torch.modes.__all__)
    for name in aes.__all__:
        assert hasattr(aes, name), name
    for name in micro_aes_tpu_torch.modes.__all__:
        assert hasattr(micro_aes_tpu_torch.modes, name), name


# -- every function on the main.c vectors -------------------------------------

def test_block_modes_round_trip():
    assert compat.AES_Cipher(kat.FIPS_KEY128, "D", kat.FIPS_CT128, device=CPU) == kat.FIPS_PT
    assert compat.AES_Cipher(kat.FIPS_KEY256, 1, kat.FIPS_PT, device=CPU) == kat.FIPS_CT256
    assert compat.AES_ECB_encrypt(KEY, PT, device=CPU) == kat.ECB128
    code, out = compat.AES_ECB_decrypt(KEY, kat.ECB128, device=CPU)
    assert code == OK and out[: len(PT)] == PT
    assert compat.AES_ECB_decrypt(KEY, kat.ECB128[:-1], device=CPU) == \
        (compat.M_DECRYPTION_ERROR, b"")
    assert compat.AES_CBC_encrypt(KEY, IV, PT, device=CPU) == (OK, kat.CBC128_CTS)
    assert compat.AES_CBC_decrypt(KEY, IV, kat.CBC128_CTS, device=CPU) == (OK, PT)
    assert compat.AES_CBC_decrypt(KEY, IV, b"short", device=CPU)[0] == compat.M_DATALENGTH_ERROR
    assert compat.AES_CFB_encrypt(KEY, IV, PT, device=CPU) == kat.CFB128
    assert compat.AES_CFB_decrypt(KEY, IV, kat.CFB128, device=CPU) == PT
    assert compat.AES_OFB_encrypt(KEY, IV, PT, device=CPU) == kat.OFB128
    assert compat.AES_OFB_decrypt(KEY, IV, kat.OFB128, device=CPU) == PT
    assert compat.AES_CTR_encrypt(KEY, IV, PT, device=CPU) == kat.CTR128
    assert compat.AES_CTR_decrypt(KEY, IV, kat.CTR128, device=CPU) == PT


@pytest.mark.parametrize("vector", kat.XTS_VECTORS, ids=lambda v: v[0])
def test_xts_round_trip(vector):
    _, keys, tweak, pt, ct = vector
    assert compat.AES_XTS_encrypt(keys, tweak, pt, device=CPU) == (OK, ct)
    assert compat.AES_XTS_decrypt(keys, tweak, ct, device=CPU) == (OK, pt)
    assert compat.AES_XTS_encrypt(keys, tweak, pt[:15], device=CPU)[0] == \
        compat.M_DATALENGTH_ERROR


def test_aead_round_trip_and_tamper():
    cases = [  # (encrypt, decrypt, key, nonce, answer)
        (compat.AES_GCM_encrypt, compat.AES_GCM_decrypt, KEY, IV[:12], kat.GCM128),
        (compat.AES_CCM_encrypt, compat.AES_CCM_decrypt, KEY, IV[:11], kat.CCM128),
        (compat.AES_OCB_encrypt, compat.AES_OCB_decrypt, KEY, IV[:12], kat.OCB_VECTORS[0][5]),
        (compat.AES_EAX_encrypt, compat.AES_EAX_decrypt, KEY, IV, kat.EAX128),
        (compat.GCM_SIV_encrypt, compat.GCM_SIV_decrypt, KEY, IV[:12], kat.GCMSIV128),
    ]
    for enc, dec, key, nonce, want in cases:
        assert enc(key, nonce, AAD, PT, device=CPU) == want, enc.__name__
        assert dec(key, nonce, AAD, want, device=CPU) == (OK, PT), dec.__name__
        assert dec(key, nonce, AAD, _tamper(want), device=CPU) == \
            (compat.M_AUTHENTICATION_ERROR, b""), dec.__name__


def test_siv_round_trip_and_tamper():
    iv, ct = compat.AES_SIV_encrypt(kat.CIPHER_KEY, AAD, PT, device=CPU)
    assert iv + ct == kat.SIV128
    assert compat.AES_SIV_decrypt(kat.CIPHER_KEY, iv, AAD, ct, device=CPU) == (OK, PT)
    assert compat.AES_SIV_decrypt(kat.CIPHER_KEY, _tamper(iv), AAD, ct, device=CPU) == \
        (compat.M_AUTHENTICATION_ERROR, b"")


@pytest.mark.parametrize("klen, want", kat.KW_VECTORS, ids=["KW128", "KW192", "KW256"])
def test_key_wrap_round_trip(klen, want):
    kek, secret = kat.SECRET_KEY[:klen], kat.SECOND_KEY[:klen]
    assert compat.AES_KEY_wrap(kek, secret, device=CPU) == (OK, want)
    assert compat.AES_KEY_unwrap(kek, want, device=CPU) == (OK, secret)
    assert compat.AES_KEY_unwrap(kek, _tamper(want), device=CPU) == \
        (compat.M_AUTHENTICATION_ERROR, b"")


def test_fpe_round_trip():
    assert compat.AES_FPE_decrypt(KEY, AAD, kat.FPE_FF1_CIPHER, device=CPU) == (OK, kat.FPE_PLAIN)
    pt = kat.FPE_PLAIN[:55]
    assert compat.AES_FPE_encrypt(KEY, AAD[:7], pt, "digits", "ff3-1", device=CPU) == \
        (OK, kat.FPE_FF3_CIPHER)
    assert compat.AES_FPE_decrypt(KEY, AAD[:7], kat.FPE_FF3_CIPHER, "digits", "ff3-1",
                                  device=CPU) == (OK, pt)
    assert compat.AES_FPE_decrypt(KEY, AAD[:7], "12x45678", "digits", "ff3-1",
                                  device=CPU) == (compat.M_DECRYPTION_ERROR, b"")


# -- the default device -------------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda: aes.poly1305_aes(kat.CIPHER_KEY, IV, PT),
    lambda: aes.fpe_encrypt(KEY, AAD, kat.FPE_PLAIN),
    lambda: aes.fpe_encrypt(KEY, AAD[:7], kat.FPE_PLAIN[:55], "digits", "ff3-1"),
    lambda: compat.AES_CMAC(KEY, PT),
], ids=["poly1305_aes", "fpe_encrypt ff1", "fpe_encrypt ff3-1", "AES_CMAC"])
def test_default_device_is_cuda(call):
    """Without a GPU the default device="cuda" raises: nothing falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    with pytest.raises((AssertionError, RuntimeError)):
        call()


def test_purge_reaches_the_new_caches():
    from micro_aes_tpu_torch.fpe import device as tdev
    from micro_aes_tpu_torch.ops import poly_bulk
    from micro_aes_tpu_torch.utils.keycache import registered_key_caches

    aes.poly1305_aes(kat.CIPHER_KEY, IV, bytes(1 << 16), device=CPU)  # the bulk fold
    tdev.fpe_encrypt_batch(KEY, bytes(7), ["0123456789"], "digits", "ff3-1", device=CPU)
    caches = (poly_bulk.poly_power_tables, tdev._kp)
    assert all(c in registered_key_caches() and c.cache_info().currsize for c in caches)
    aes.purge_key_caches()
    assert not any(c.cache_info().currsize for c in caches)
