"""The plain reference against published vectors, on the CPU."""
import numpy as np
import pytest
import torch

from perfbench.reference import aes, gcm, xts

H = bytes.fromhex

# FIPS-197 appendix C: (key, ciphertext) for plaintext 00112233..eeff
FIPS_PT = H("00112233445566778899aabbccddeeff")
FIPS = [
    (H("000102030405060708090a0b0c0d0e0f"), H("69c4e0d86a7b0430d8cdb78070b4c55a")),
    (H("000102030405060708090a0b0c0d0e0f1011121314151617"), H("dda97ca4864cdfe06eaf70a0ec0d7191")),
    (H("000102030405060708090a0b0c0d0e0f101112131415161718191a1b1c1d1e1f"),
     H("8ea2b7ca516745bfeafc49904b496089")),
]

# McGrew & Viega, "The Galois/Counter Mode of Operation", appendix B
MV_KEY = H("feffe9928665731c6d6a8f9467308308")
MV_IV = H("cafebabefacedbaddecaf888")
MV_PT = H("d9313225f88406e5a55909c5aff5269a86a7a9531534f7da2e4c303d8a318a72"
          "1c3c0c95956809532fcf0e2449a6b525b16aedf5aa0de657ba637b391aafd255")
MV_CT = H("42831ec2217774244b7221b784d0d49ce3aa212f2c02a4e035c17e2329aca12e"
          "21d514b25466931c7d8f6a5aac84aa051ba30b396a0aac973d58e091473f5985")
MV_AAD = H("feedfacedeadbeeffeedfacedeadbeefabaddad2")
GCM_CASES = [  # (name, key, iv, aad, pt, ct, tag)
    ("test case 2", bytes(16), bytes(12), b"", bytes(16), H("0388dace60b6a392f328c2b971b2fe78"),
     H("ab6e47d42cec13bdf53a67b21257bddf")),
    ("test case 3", MV_KEY, MV_IV, b"", MV_PT, MV_CT, H("4d5c2af327cd64a62cf35abd2ba6fab4")),
    ("test case 4", MV_KEY, MV_IV, MV_AAD, MV_PT[:60], MV_CT[:60],
     H("5bc94fbc3221a5db94fae95ae7121a47")),
]

# IEEE 1619-2007 annex B, vector 10 (XTS-AES-256, data unit 0xff, 512 bytes)
XTS_KEY = H("2718281828459045235360287471352662497757247093699959574966967627"
            "3141592653589793238462643383279502884197169399375105820974944592")
XTS_PT = bytes(range(256)) * 2
XTS_CT = H(
    "1c3b3a102f770386e4836c99e370cf9bea00803f5e482357a4ae12d414a3e63b"
    "5d31e276f8fe4a8d66b317f9ac683f44680a86ac35adfc3345befecb4bb188fd"
    "5776926c49a3095eb108fd1098baec70aaa66999a72a82f27d848b21d4a741b0"
    "c5cd4d5fff9dac89aeba122961d03a757123e9870f8acf1000020887891429ca"
    "2a3e7a7d7df7b10355165c8b9a6d0a7de8b062c4500dc4cd120c0f7418dae3d0"
    "b5781c34803fa75421c790dfe1de1834f280d7667b327f6c8cd7557e12ac3a0f"
    "93ec05c52e0493ef31a12d3d9260f79a289d6a379bc70c50841473d1a8cc81ec"
    "583e9645e07b8d9670655ba5bbcfecc6dc3966380ad8fecb17b6ba02469a020a"
    "84e18e8f84252070c13e9f1f289be54fbc481457778f616015e1327a02b140f1"
    "505eb309326d68378f8374595c849d84f4c333ec4423885143cb47bd71c5edae"
    "9be69a2ffeceb1bec9de244fbe15992b11b77c040f12bd8f6a975a44a0f90c29"
    "a9abc3d4d893927284c58754cce294529f8614dcd2aba991925fedc4ae74ffac"
    "6e333b93eb4aff0479da9a410e4450e0dd7ae4c6e2910900575da401fc07059f"
    "645e8b7e9bfdef33943054ff84011493c27b3429eaedb4ed5376441a77ed4385"
    "1ad77f16f541dfd269d50d6a5f14fb0aab1cbb4c1550be97f7ab4066193c4caa"
    "773dad38014bd2092fa755c824bb5e54c4f36ffda9fcea70b9c6e693e148c151")


def _block(b: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(b, np.uint8).copy())[None]


@pytest.mark.parametrize("key,ct", FIPS, ids=["aes128", "aes192", "aes256"])
def test_fips197(key, ct):
    rk = aes.round_keys([key], "cpu")[0]
    assert aes.encrypt(rk, _block(FIPS_PT)).numpy().tobytes() == ct
    assert aes.decrypt(rk, _block(ct)).numpy().tobytes() == FIPS_PT


def test_sbox_is_the_standard_one():
    assert aes.SBOX[0] == 0x63 and aes.SBOX[0x53] == 0xED and aes.INV_SBOX[0x63] == 0


@pytest.mark.parametrize("case", GCM_CASES, ids=[c[0] for c in GCM_CASES])
def test_gcm_mcgrew_viega(case):
    _, key, iv, aad, pt, ct, tag = case
    assert gcm.seal([key], [iv], [aad], [pt]) == [ct + tag]
    assert gcm.open_([key], [iv], [aad], [ct + tag]) == [pt]
    forged = bytearray(ct + tag)
    forged[-3] ^= 0x10
    assert gcm.open_([key], [iv], [aad], [bytes(forged)]) == [None]


def test_gcm_batch_of_mixed_lengths_equals_one_at_a_time():
    rng = np.random.default_rng(5)
    n = 9
    keys = [rng.bytes(16) for _ in range(n)]
    ivs = [rng.bytes(12) for _ in range(n)]
    aads = [rng.bytes(int(rng.integers(0, 40))) for _ in range(n)]
    pts = [rng.bytes(int(rng.integers(0, 70))) for _ in range(n)]
    batch = gcm.seal(keys, ivs, aads, pts)
    assert batch == [gcm.seal([k], [v], [a], [p])[0] for k, v, a, p in zip(keys, ivs, aads, pts)]
    assert gcm.open_(keys, ivs, aads, batch) == pts


def test_xts_ieee1619_vector10():
    assert xts.xts(XTS_KEY, [0xFF], XTS_PT, 512, False) == XTS_CT
    assert xts.xts(XTS_KEY, [0xFF], XTS_CT, 512, True) == XTS_PT


def test_xts_sectors_are_independent_units():
    two = xts.xts(XTS_KEY, [0xFF, 0x100], XTS_PT * 2, 512, False)
    assert two[:512] == XTS_CT
    assert two[512:] == xts.xts(XTS_KEY, [0x100], XTS_PT, 512, False) != XTS_CT
