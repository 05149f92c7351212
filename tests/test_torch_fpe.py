"""The port's format-preserving encryption (micro_aes_tpu_torch fpe: the
alphabets, FF1/FF3/FF3-1 one token at a time, and the batched Feistel of
fpe/device) against the JAX package, on the CPU.

The JAX side runs only its host paths (`fpe_encrypt`/`fpe_decrypt`, which
the JAX package's own tests hold against its device engine and the
reference corpus) and its numpy table and wire helpers; its jitted device
FPE compiles once per (radix, length, method) and is not called.  On the
CPU the port's FF1 PRF runs K13's plain version and the batches' PRF
encrypts K2's plain version.  Every comparison is exact.
"""
import numpy as np
import pytest
import torch

from micro_aes_tpu import fpe as jfpe
from micro_aes_tpu.errors import MicroAesError as JaxMicroAesError
from micro_aes_tpu.fpe import device as jdev

import micro_aes_tpu_torch as aes
from micro_aes_tpu_torch import DecryptionError, EncryptionError
from micro_aes_tpu_torch.fpe import device as tdev
from micro_aes_tpu_torch.fpe.alphabet import ALPHABETS, Alphabet, resolve_alphabet
from micro_aes_tpu_torch.ops import cipher_kernel
from micro_aes_tpu_torch.testing import kat, rsp

CPU = "cpu"
KEY = kat.CIPHER_KEY[:16]
AAD = kat.AAD


def _tokens(rng, alpha: Alphabet, lengths) -> list[str]:
    return ["".join(alpha.chars[i] for i in rng.integers(0, alpha.radix, n)) for n in lengths]


# -- one token at a time ------------------------------------------------------

def test_main_c_ff1():
    out = aes.fpe_encrypt(KEY, AAD, kat.FPE_PLAIN, "digits", "ff1", device=CPU)
    assert out == kat.FPE_FF1_CIPHER
    assert aes.fpe_decrypt(KEY, AAD, out, "digits", "ff1", device=CPU) == kat.FPE_PLAIN


def test_main_c_ff3_1():
    pt = kat.FPE_PLAIN[:55]
    out = aes.fpe_encrypt(KEY, AAD[:7], pt, "digits", "ff3-1", device=CPU)
    assert out == kat.FPE_FF3_CIPHER
    assert aes.fpe_decrypt(KEY, AAD[:7], out, "digits", "ff3-1", device=CPU) == pt


FUZZ_ALPHABETS = ("digits", "binary", "alnum_lower", "base85", "greek")


@pytest.mark.parametrize("alphabet", FUZZ_ALPHABETS)
@pytest.mark.parametrize("method", ["ff1", "ff3", "ff3-1"])
def test_host_matches_jax(method, alphabet):
    """Encrypt and decrypt == JAX's host path, lengths from MINLEN to 40
    (MAXLEN for FF3).  FF1 takes one token a case (each round is a K13
    plain-version CBC-MAC here), FF3 three."""
    rng = np.random.default_rng(FUZZ_ALPHABETS.index(alphabet) * 3 + len(method))
    alpha = ALPHABETS[alphabet]
    hi = 40 if method == "ff1" else min(40, alpha.max_len_ff3())
    lengths = [alpha.min_len, hi, int(rng.integers(alpha.min_len, hi + 1))]
    if method == "ff1":
        lengths = lengths[FUZZ_ALPHABETS.index(alphabet) % 3:][:1]
    key = rng.integers(0, 256, int(rng.choice([16, 24, 32])), dtype=np.uint8).tobytes()
    tlen = {"ff1": int(rng.integers(0, 9)), "ff3": 8, "ff3-1": 7}[method]  # FF1: the KAT's is 31
    tweak = rng.integers(0, 256, tlen, dtype=np.uint8).tobytes()
    for tok in _tokens(rng, alpha, lengths):
        ct = aes.fpe_encrypt(key, tweak, tok, alphabet, method, device=CPU)
        assert ct == jfpe.fpe_encrypt(key, tweak, tok, alphabet, method)
        assert aes.fpe_decrypt(key, tweak, ct, alphabet, method, device=CPU) == tok


ERROR_CASES = [
    ("too short", True, "123", "digits", "ff1"),
    ("too short (decrypt)", False, "12345", "digits", "ff3-1"),
    ("too long for FF3", True, "1" * 57, "digits", "ff3-1"),
    ("too long for FF3 (decrypt)", False, "0" * 57, "digits", "ff3"),
    ("bad character", True, "123456x", "digits", "ff1"),
    ("bad character (decrypt)", False, "abcdefg!", "lower", "ff3-1"),
    ("unknown method", True, "1234567", "digits", "ff2"),
]


@pytest.mark.parametrize("case", ERROR_CASES, ids=[c[0] for c in ERROR_CASES])
def test_error_contract_matches_jax(case):
    _, encrypt, text, alphabet, method = case
    tweak = bytes(7)
    jfn, tfn = ((jfpe.fpe_encrypt, aes.fpe_encrypt) if encrypt
                else (jfpe.fpe_decrypt, aes.fpe_decrypt))
    with pytest.raises((JaxMicroAesError, ValueError)) as jerr:
        jfn(KEY, tweak, text, alphabet, method)
    with pytest.raises((EncryptionError, DecryptionError, ValueError)) as terr:
        tfn(KEY, tweak, text, alphabet, method, device=CPU)
    assert type(terr.value).__name__ == type(jerr.value).__name__
    if isinstance(terr.value, EncryptionError | DecryptionError):
        assert terr.value.code == jerr.value.code
        assert isinstance(terr.value, EncryptionError if encrypt else DecryptionError)


@pytest.mark.parametrize("name", sorted(jfpe.ALPHABETS))
def test_alphabets_match_jax(name):
    got, want = ALPHABETS[name], jfpe.ALPHABETS[name]
    assert (got.chars, got.radix, got.min_len, got.max_len_ff3()) == \
        (want.chars, want.radix, want.min_len, want.max_len_ff3())
    assert resolve_alphabet(name) is got


def test_alphabet_registry_is_jaxs():
    assert sorted(ALPHABETS) == sorted(jfpe.ALPHABETS)
    custom = resolve_alphabet("xyz")
    assert isinstance(custom, Alphabet) and custom.radix == 3


def test_tv_corpus():
    """The reference's FPE corpus through the host and batch paths (skips
    where the corpus is not present)."""
    path = rsp.REFERENCE_VECTORS / "FPE_FF1&FF3&FF3-1.tv"
    if not path.exists():
        pytest.skip(f"reference corpus not present: {path}")
    for r in rsp.load_fpe():
        tweak = rsp.hexval(r, "Tweak")
        method = r["Method"].strip().lower()
        if method == "ff3":
            method = "ff3" if len(tweak) == 8 else "ff3-1"
        args = (rsp.hexval(r, "Key"), tweak)
        assert aes.fpe_encrypt(*args, r["PT"], r["Alphabet"], method, device=CPU) == r["CT"]
        assert tdev.fpe_decrypt_batch(*args, [r["CT"]], r["Alphabet"], method,
                                      device=CPU) == [r["PT"]]


# -- batches ------------------------------------------------------------------

RADICES = (2, 10, 16, 17, 36, 256)


@pytest.mark.parametrize("radix", RADICES)
def test_num_tables_match_jax(radix):
    for length, nbytes, msd in ((16, 7, True), (9, 12, False), (1, 3, True)):
        np.testing.assert_array_equal(tdev._num_table(radix, length, nbytes, msd),
                                      jdev._num_table(radix, length, nbytes, msd))


@pytest.mark.parametrize("radix", RADICES)
def test_ydig_tables_match_jax(radix):
    for nbytes, m in ((8, 8), (16, 3), (20, 29)):
        np.testing.assert_array_equal(tdev._ydig_table(radix, nbytes, m),
                                      jdev._ydig_table(radix, nbytes, m))


@pytest.mark.parametrize("radix", RADICES)
def test_wire_matches_jax(radix):
    """Nibble pack/unpack (radix <= 16) on the host and on the device side
    == JAX's numpy helpers; wider radices travel a digit a byte."""
    assert tdev._wire_packed(radix) == jdev._wire_packed(radix)
    rng = np.random.default_rng(radix)
    for n in (7, 8):
        d = rng.integers(0, radix, (5, n)).astype(np.uint8)
        if not tdev._wire_packed(radix):
            w = tdev._to_wire(torch.from_numpy(d.astype(np.int32)), radix)
            np.testing.assert_array_equal(w.numpy(), d)
            continue
        w = jdev._pack_nibbles_np(d)
        np.testing.assert_array_equal(tdev._pack_nibbles_np(d), w)
        np.testing.assert_array_equal(tdev._unpack_nibbles_np(w, n), jdev._unpack_nibbles_np(w, n))
        wt = tdev._pack_nibbles_t(torch.from_numpy(d.astype(np.int32)))
        np.testing.assert_array_equal(wt.numpy(), w)
        np.testing.assert_array_equal(tdev._unpack_nibbles_t(wt, n).numpy(), d)


def test_carry_scan_floors_negative_values():
    """Decryption subtracts: the carries must divide with floor."""
    acc = torch.tensor([[-1, 0, 0], [-25, 3, 0], [19, -1, 2]], dtype=torch.int32)
    got = tdev._carry_scan(acc, 10).tolist()
    # LSD first, mod 10^3: -1 -> 999, 3*10 - 25 = 5 -> 005, 19 - 10 + 200 = 209
    assert got == [[9, 9, 9], [5, 0, 0], [9, 0, 2]]


BATCH_CASES = [  # (method, alphabet, tweak, lengths of one mixed call)
    ("ff1", "digits", b"tweak", (10, 20)),
    ("ff1", "alnum_lower", b"\x01\x02", (12,)),
    ("ff1", "base64", b"", (9,)),
    ("ff3-1", "digits", bytes(range(7)), (10, 20)),
    ("ff3-1", "alnum_lower", bytes(range(1, 8)), (12,)),
    ("ff3-1", "base64", bytes(7), (9,)),
]


@pytest.mark.parametrize("case", BATCH_CASES, ids=[f"{c[0]}-{c[1]}" for c in BATCH_CASES])
def test_batch_matches_host_paths(case):
    """Mixed lengths in one call, both directions: == JAX's host path token
    by token, and (digits) the port's own host path on a sample."""
    method, alphabet, tweak, lengths = case
    rng = np.random.default_rng(len(lengths) + len(tweak))
    alpha = ALPHABETS[alphabet]
    toks = _tokens(rng, alpha, [n for n in lengths for _ in range(2)])
    out = tdev.fpe_encrypt_batch(KEY, tweak, toks, alphabet, method, device=CPU)
    assert out == [jfpe.fpe_encrypt(KEY, tweak, t, alphabet, method) for t in toks]
    if alphabet == "digits":
        assert aes.fpe_encrypt(KEY, tweak, toks[-1], alphabet, method, device=CPU) == out[-1]
    assert tdev.fpe_decrypt_batch(KEY, tweak, out, alphabet, method, device=CPU) == toks


def test_batch_main_c_vectors():
    assert tdev.fpe_encrypt_batch(KEY, AAD, [kat.FPE_PLAIN], device=CPU) == [kat.FPE_FF1_CIPHER]
    pt = kat.FPE_PLAIN[:55]
    out = tdev.fpe_encrypt_batch(KEY, AAD[:7], [pt], "digits", "ff3-1", device=CPU)
    assert out == [kat.FPE_FF3_CIPHER]
    assert tdev.fpe_decrypt_batch(KEY, AAD[:7], out, "digits", "ff3-1", device=CPU) == [pt]


def test_batch_prf_runs_on_k2(monkeypatch):
    """Every batched PRF encrypt goes through cipher_planes (K2's wrapper)
    on whole 32-block plane words: FF3-1 is one per round."""
    calls = []
    wrapped = cipher_kernel.cipher_planes

    def spy(kp, planes, decrypt=False):
        calls.append(planes.shape[-1])
        return wrapped(kp, planes, decrypt)

    monkeypatch.setattr(tdev, "cipher_planes", spy)
    toks = _tokens(np.random.default_rng(5), ALPHABETS["digits"], [16] * 40)
    out = tdev.fpe_encrypt_batch(KEY, bytes(7), toks, "digits", "ff3-1", device=CPU)
    assert calls == [2] * 8  # 40 tokens padded to 64: two plane words
    assert out == [jfpe.fpe_encrypt(KEY, bytes(7), t, "digits", "ff3-1") for t in toks]


def test_digit_api_matches_string_batch():
    """fpe_{en,de}crypt_digits agree with the string batch and round-trip
    on a batch that is not a multiple of 32."""
    rng = np.random.default_rng(23)
    d = rng.integers(0, 10, (37, 16), dtype=np.uint8)
    toks = ["".join("0123456789"[v] for v in row) for row in d]
    ct = tdev.fpe_encrypt_digits(KEY, b"\x01\x02", d, 10, "ff1", device=CPU)
    assert ct.dtype == np.uint8 and ct.shape == d.shape
    want = tdev.fpe_encrypt_batch(KEY, b"\x01\x02", toks, "digits", "ff1", device=CPU)
    assert ["".join("0123456789"[v] for v in row) for row in ct] == want
    assert want[:4] == [jfpe.fpe_encrypt(KEY, b"\x01\x02", t) for t in toks[:4]]
    np.testing.assert_array_equal(
        tdev.fpe_decrypt_digits(KEY, b"\x01\x02", ct, 10, "ff1", device=CPU), d)


def test_digit_api_validation():
    with pytest.raises(EncryptionError):
        tdev.fpe_encrypt_digits(KEY, b"", np.zeros(16, np.uint8), 10, device=CPU)
    with pytest.raises(EncryptionError):
        tdev.fpe_encrypt_digits(KEY, b"", np.zeros((4, 16), np.uint8), 1000, device=CPU)
    with pytest.raises(DecryptionError):
        tdev.fpe_decrypt_digits(KEY, b"", np.zeros((4, 16), np.uint8), 1, device=CPU)


def test_batch_error_contract():
    with pytest.raises(EncryptionError):
        tdev.fpe_encrypt_batch(KEY, b"", ["123"], "digits", "ff1", device=CPU)
    with pytest.raises(EncryptionError):
        tdev.fpe_encrypt_batch(KEY, b"", ["123456x"], "digits", "ff1", device=CPU)
    with pytest.raises(DecryptionError):
        tdev.fpe_decrypt_batch(KEY, b"", ["123"], "digits", "ff1", device=CPU)
    with pytest.raises(DecryptionError):
        tdev.fpe_decrypt_batch(KEY, bytes(7), ["1" * 57], "digits", "ff3-1", device=CPU)
    with pytest.raises(ValueError):
        tdev.fpe_encrypt_batch(KEY, b"", ["1234567"], "digits", "ff2", device=CPU)


@pytest.mark.parametrize("method", ["ff1", "ff3-1"])
def test_chunked_dispatch_matches_unchunked(method, monkeypatch):
    """With FPE_CHUNK shrunk to 32, a 40-token batch runs as two chunks and
    agrees with the one-chunk run, both ways."""
    rng = np.random.default_rng(11)
    key = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    tweak = b"\x01\x02" if method == "ff1" else bytes(7)
    dmat = rng.integers(0, 10, (40, 6), dtype=np.uint8)
    flat = tdev.fpe_encrypt_digits(key, tweak, dmat, 10, method, device=CPU)
    monkeypatch.setattr(tdev, "FPE_CHUNK", 32)
    chunked = tdev.fpe_encrypt_digits(key, tweak, dmat, 10, method, device=CPU)
    np.testing.assert_array_equal(flat, chunked)
    np.testing.assert_array_equal(
        tdev.fpe_decrypt_digits(key, tweak, chunked, 10, method, device=CPU), dmat)


def test_wide_radix_takes_host_route(monkeypatch):
    """Alphabets above radix 256 run the host path token by token."""
    alpha = Alphabet("".join(chr(0x4E00 + i) for i in range(300)))
    toks = _tokens(np.random.default_rng(4), alpha, [5, 9])

    def no_device(*args, **kwargs):
        raise AssertionError("a radix-300 batch reached the device dispatch")

    monkeypatch.setattr(tdev, "_dispatch_digits", no_device)
    out = tdev.fpe_encrypt_batch(KEY, bytes(7), toks, alpha, "ff3-1", device=CPU)
    assert out == [jfpe.fpe_encrypt(KEY, bytes(7), t, jfpe.Alphabet(alpha.chars), "ff3-1")
                   for t in toks]
    assert tdev.fpe_decrypt_batch(KEY, bytes(7), out, alpha, "ff3-1", device=CPU) == toks
