"""Faults of the port found against the JAX package, each pinned on the CPU.

F9: GCM-SIV decrypt of an input shorter than its tag raises the reference's
AuthenticationError, and compat returns its code.  F10: an IV shorter than
16 bytes raises DataLengthError wherever the reference fails on it (the JAX
package crashes there with foreign exceptions, so these cases call no JAX),
while the cases where both packages already agree stay as they are.  F11:
compat.AES_Cipher on an empty block returns b"", as the JAX package does.
"""
import pytest

from micro_aes_tpu import compat as jcompat
from micro_aes_tpu import errors as jerrors
from micro_aes_tpu.modes import gcm_siv as jgcm_siv

import micro_aes_tpu_torch as aes
from micro_aes_tpu_torch import compat
from micro_aes_tpu_torch.errors import AuthenticationError, DataLengthError
from micro_aes_tpu_torch.modes import bulk, chain_bulk

CPU = "cpu"
KEY = bytes(range(16))
SIV_KEYS = bytes(range(32))
NONCE = bytes(range(12))


# -- F9 ----------------------------------------------------------------------

@pytest.mark.parametrize("klen", (16, 32))
@pytest.mark.parametrize("aad", (b"", b"hdr"))
@pytest.mark.parametrize("nbytes", (0, 1, 15))
def test_gcm_siv_decrypt_shorter_than_tag(nbytes, aad, klen):
    key = bytes(range(klen))
    data = bytes(range(nbytes))
    with pytest.raises(jerrors.AuthenticationError):
        jgcm_siv.gcm_siv_decrypt(key, NONCE, aad, data)
    with pytest.raises(AuthenticationError):
        aes.gcm_siv_decrypt(key, NONCE, aad, data, device=CPU)
    got = compat.GCM_SIV_decrypt(key, NONCE, aad, data, device=CPU)
    assert got == jcompat.GCM_SIV_decrypt(key, NONCE, aad, data)
    assert got == (compat.M_AUTHENTICATION_ERROR, b"") == (0x1A, b"")


# -- F10 ---------------------------------------------------------------------

def _per_message(site, iv, data):
    calls = {
        "cbc_encrypt": lambda: aes.cbc_encrypt(KEY, iv, data, device=CPU),
        "cbc_encrypt_nocts": lambda: aes.cbc_encrypt(KEY, iv, data, cts=False, device=CPU),
        "cbc_decrypt": lambda: aes.cbc_decrypt(KEY, iv, data, device=CPU),
        "cbc_decrypt_nocts": lambda: aes.cbc_decrypt(KEY, iv, data[:32], cts=False,
                                                     device=CPU),
        "cfb_encrypt": lambda: aes.cfb_encrypt(KEY, iv, data, device=CPU),
        "cfb_decrypt": lambda: aes.cfb_decrypt(KEY, iv, data, device=CPU),
        "ofb_encrypt": lambda: aes.ofb_encrypt(KEY, iv, data, device=CPU),
        "siv_decrypt": lambda: aes.siv_decrypt(SIV_KEYS, iv, b"", data, device=CPU),
        "cbc_encrypt_batch": lambda: chain_bulk.cbc_encrypt_batch([KEY], [iv], [data],
                                                                  device=CPU),
        "cbc_decrypt_batch": lambda: chain_bulk.cbc_decrypt_batch([KEY], [iv], [data],
                                                                  device=CPU),
        "cfb_encrypt_batch": lambda: chain_bulk.cfb_encrypt_batch([KEY], [iv], [data],
                                                                  device=CPU),
        "cfb_decrypt_batch": lambda: chain_bulk.cfb_decrypt_batch([KEY], [iv], [data],
                                                                  device=CPU),
        "ofb_xcrypt_batch": lambda: chain_bulk.ofb_xcrypt_batch([KEY], [iv], [data],
                                                                device=CPU),
        "siv_decrypt_batch": lambda: bulk.siv_decrypt_batch([SIV_KEYS], [iv], [b""], [data],
                                                            device=CPU),
    }
    return calls[site]()


F10_SITES = ("cbc_encrypt", "cbc_encrypt_nocts", "cbc_decrypt", "cbc_decrypt_nocts",
             "cfb_encrypt", "cfb_decrypt", "ofb_encrypt", "siv_decrypt",
             "cbc_encrypt_batch", "cbc_decrypt_batch", "cfb_encrypt_batch",
             "cfb_decrypt_batch", "ofb_xcrypt_batch", "siv_decrypt_batch")


@pytest.mark.parametrize("ivlen", (0, 15))
@pytest.mark.parametrize("site", F10_SITES)
def test_short_iv_raises_data_length_error(site, ivlen):
    with pytest.raises(DataLengthError):
        _per_message(site, bytes(ivlen), bytes(range(33)))


def test_short_iv_cases_that_agree_stay():
    """What the JAX package does with these without failing, checked on the
    same calls beforehand: an empty message needs no IV, and SIV's compare
    fails."""
    iv = bytes(15)
    assert aes.cfb_encrypt(KEY, iv, b"", device=CPU) == b""
    assert aes.cfb_decrypt(KEY, iv, b"", device=CPU) == b""
    assert aes.ofb_encrypt(KEY, iv, b"", device=CPU) == b""
    assert aes.cbc_encrypt(KEY, iv, b"", cts=False, device=CPU) == b""
    with pytest.raises(AuthenticationError):
        aes.siv_decrypt(SIV_KEYS, iv, b"", b"", device=CPU)
    assert bulk.siv_decrypt_batch([SIV_KEYS], [iv], [b""], [b""], device=CPU) == [None]
    with pytest.raises(DataLengthError):  # the reference reads byte 12 of it
        bulk.siv_decrypt_batch([SIV_KEYS], [bytes(12)], [b""], [b""], device=CPU)
    # a longer IV is cut to its first block in both packages
    long_iv = bytes(range(20))
    assert aes.cbc_encrypt(KEY, long_iv, bytes(32), device=CPU) == \
        aes.cbc_encrypt(KEY, long_iv[:16], bytes(32), device=CPU)


# -- F11 ---------------------------------------------------------------------

@pytest.mark.parametrize("mode", ("E", "D"))
@pytest.mark.parametrize("nbytes", (0, 5, 20))
def test_aes_cipher_block_lengths(nbytes, mode):
    block = bytes(range(100, 100 + nbytes))
    got = compat.AES_Cipher(KEY, mode, block, device=CPU)
    assert got == jcompat.AES_Cipher(KEY, mode, block)
    assert len(got) == (0 if nbytes == 0 else 16)
