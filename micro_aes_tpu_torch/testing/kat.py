"""Known-answer vectors for the AES-GCM, GCM-SIV, XTS, OCB, ECB, CBC, CFB,
OFB, CTR, CMAC, CCM, EAX, EAX', SIV and KW paths of the port.

* FIPS-197 appendix C single-block answers (plaintext 00112233..eeff).
* Whole-block AES-GCM vectors with 96-bit IVs and no AAD from McGrew &
  Viega, "The Galois/Counter Mode of Operation (GCM)", appendix B: test
  cases 2 (AES-128, one zero block), 3 (AES-128), 9 (AES-192) and 15
  (AES-256), the last three on the same 64-byte plaintext and IV.
"""
from ..utils.bytesio import hex2bytes

# FIPS-197 appendix C known answers (single block).
FIPS_PT = hex2bytes("00112233445566778899aabbccddeeff")
FIPS_KEY128 = hex2bytes("000102030405060708090a0b0c0d0e0f")
FIPS_CT128 = hex2bytes("69c4e0d86a7b0430d8cdb78070b4c55a")
FIPS_KEY192 = hex2bytes("000102030405060708090a0b0c0d0e0f1011121314151617")
FIPS_CT192 = hex2bytes("dda97ca4864cdfe06eaf70a0ec0d7191")
FIPS_KEY256 = hex2bytes(
    "000102030405060708090a0b0c0d0e0f101112131415161718191a1b1c1d1e1f"
)
FIPS_CT256 = hex2bytes("8ea2b7ca516745bfeafc49904b496089")

FIPS_VECTORS = (
    (FIPS_KEY128, FIPS_PT, FIPS_CT128),
    (FIPS_KEY192, FIPS_PT, FIPS_CT192),
    (FIPS_KEY256, FIPS_PT, FIPS_CT256),
)

_GCM_SPEC_PT = hex2bytes(
    "d9313225f88406e5a55909c5aff5269a86a7a9531534f7da2e4c303d8a318a72"
    "1c3c0c95956809532fcf0e2449a6b525b16aedf5aa0de657ba637b391aafd255"
)
_GCM_SPEC_IV = hex2bytes("cafebabefacedbaddecaf888")

# (name, key, iv, plaintext, ciphertext, tag)
GCM_SPEC_VECTORS = (
    ("test case 2", bytes(16), bytes(12), bytes(16),
     hex2bytes("0388dace60b6a392f328c2b971b2fe78"),
     hex2bytes("ab6e47d42cec13bdf53a67b21257bddf")),
    ("test case 3", hex2bytes("feffe9928665731c6d6a8f9467308308"),
     _GCM_SPEC_IV, _GCM_SPEC_PT,
     hex2bytes("42831ec2217774244b7221b784d0d49ce3aa212f2c02a4e035c17e2329aca12e"
               "21d514b25466931c7d8f6a5aac84aa051ba30b396a0aac973d58e091473f5985"),
     hex2bytes("4d5c2af327cd64a62cf35abd2ba6fab4")),
    ("test case 9",
     hex2bytes("feffe9928665731c6d6a8f9467308308feffe9928665731c"),
     _GCM_SPEC_IV, _GCM_SPEC_PT,
     hex2bytes("3980ca0b3c00e841eb06fac4872a2757859e1ceaa6efd984628593b40ca1e19c"
               "7d773d00c144c525ac619d18c84a3f4718e2448b2fe324d9ccda2710acade256"),
     hex2bytes("9924a7c8587336bfb118024db8674a14")),
    ("test case 15",
     hex2bytes("feffe9928665731c6d6a8f9467308308feffe9928665731c6d6a8f9467308308"),
     _GCM_SPEC_IV, _GCM_SPEC_PT,
     hex2bytes("522dc1f099567d07f47f37a32a84427d643a8cdcbfe5c0c97598a2bd2555d1aa"
               "8cb08e48590dbb3da7b08b1056828838c5f61e6393ba7a0abcc9f662898015ad"),
     hex2bytes("b094dac5d93471bdec1a502270e3cc6c")),
)

# McGrew & Viega appendix B test cases 4, 5 and 6 (AES-128): a 60-byte
# plaintext with 20 bytes of AAD under a 96-bit, a 64-bit and a 480-bit IV
# (the last two take J0 by GHASH).  (name, key, iv, aad, pt, ct, tag)
_GCM_SPEC_KEY = hex2bytes("feffe9928665731c6d6a8f9467308308")
_GCM_SPEC_AAD = hex2bytes("feedfacedeadbeeffeedfacedeadbeefabaddad2")
GCM_SPEC_AEAD_VECTORS = (
    ("test case 4", _GCM_SPEC_KEY, _GCM_SPEC_IV, _GCM_SPEC_AAD, _GCM_SPEC_PT[:60],
     hex2bytes("42831ec2217774244b7221b784d0d49ce3aa212f2c02a4e035c17e2329aca12e"
               "21d514b25466931c7d8f6a5aac84aa051ba30b396a0aac973d58e091"),
     hex2bytes("5bc94fbc3221a5db94fae95ae7121a47")),
    ("test case 5", _GCM_SPEC_KEY, hex2bytes("cafebabefacedbad"), _GCM_SPEC_AAD,
     _GCM_SPEC_PT[:60],
     hex2bytes("61353b4c2806934a777ff51fa22a4755699b2a714fcdc6f83766e5f97b6c7423"
               "73806900e49f24b22b097544d4896b424989b5e1ebac0f07c23f4598"),
     hex2bytes("3612d2e79e3b0785561be14aaca2fccb")),
    ("test case 6", _GCM_SPEC_KEY,
     hex2bytes("9313225df88406e555909c5aff5269aa6a7a9538534f7da1e4c303d2a318a728"
               "c3c0c95156809539fcf0e2429a6b525416aedbf5a0de6a57a637b39b"),
     _GCM_SPEC_AAD, _GCM_SPEC_PT[:60],
     hex2bytes("8ce24998625615b603a033aca13fb894be9112a5c3a211a8ba262a3cca7e2ca7"
               "01e4a9a4fba43c90ccdcb281d48c7c6fd62875d2aca417034c34aee5"),
     hex2bytes("619cc5aefffe0bfa462af43c1699d050")),
)

# AES-GCM-SIV (RFC 8452).  (name, key, nonce, aad, pt, ct || tag)
# * "main.c GCMSIV128": the reference smoke test's answer (main.c:15-88,
#   inputs built as main.c:115-123: the first 16 bytes of CIPHER_KEY, the
#   first 12 of IVEC, bytes 1..31 of SECRET_KEY as AAD, 57 bytes of
#   PLAINTEXT), generated with Crypto++ per the reference;
# * two cases of RFC 8452 (appendix C): AES-128 with "example" as AAD,
#   and a two-block message under a one-byte AAD.
_MAIN_PLAINTEXT = hex2bytes(
    "c9f775baafa36c25cd610d3c75a482eadda97ca4864cdfe06eaf70a0ec0d7191"
    "d55027cf8f900214e634412583ff0b478EA2B7CA516745BFEA"
)
_MAIN_IVEC = hex2bytes("8EA2B7CA516745BFEAfc49904b496089")
_MAIN_KEY = hex2bytes("279fb74a7572135e8f9b8ef6d1eee00369c4e0d86a7b0430d8cdb78070b4c55a")
_MAIN_AAD = hex2bytes("000102030405060708090A0B0C0D0E0F101112131415161718191A1B1C1D1E1F")[1:32]
GCMSIV128 = hex2bytes(
    "2f1488496ada3f709760420ac72e5acfa977f6add4c55ac685f1b9dff8f381e0"
    "2a64bbdd64cdd778525462949bb0b141db908c5cfa3657503666f879ac879fcb"
    "f25c15d496a1e6f7f8"
)
GCM_SIV_VECTORS = (
    ("main.c GCMSIV128", _MAIN_KEY[:16], _MAIN_IVEC[:12], _MAIN_AAD, _MAIN_PLAINTEXT,
     GCMSIV128),
    ("RFC 8452 example", hex2bytes("ee8e1ed9ff2540ae8f2ba9f50bc2f27c"),
     hex2bytes("752abad3e0afb5f434dc4310"), b"example", b"Hello world",
     hex2bytes("5d349ead175ef6b1def6fd4fbcdeb7e4793f4a1d7e4faa70100af1")),
    ("RFC 8452 two blocks", hex2bytes("01000000000000000000000000000000"),
     hex2bytes("030000000000000000000000"), hex2bytes("01"),
     hex2bytes("0200000000000000000000000000000003000000000000000000000000000000"),
     hex2bytes("620048ef3c1e73e57e02bb8562c416a319e73e4caac8e96a1ecb2933145a1d71"
               "e6af6a7f87287da059a71684ed3498e1")),
)

# XTS (main.c:15-88): (name, key1 || key2, tweak, pt, ct).  The tweak is the
# first 16 bytes of IVEC and the data 57 bytes of PLAINTEXT, so both end in
# ciphertext stealing; XTS128 takes CIPHER_KEY as its two AES-128 keys,
# XTS256 CIPHER_KEY || SECOND_KEY (main.c:119-120).
_MAIN_SECOND_KEY = hex2bytes("00112233445566778899AABBCCDDEEFF000102030405060708090A0B0C0D0E0F")
XTS_VECTORS = (
    ("main.c XTS128", _MAIN_KEY, _MAIN_IVEC, _MAIN_PLAINTEXT, hex2bytes(
        "10f9301a157bfceb3eb9e7bd38500b7e959e21ba3cc1179ad7f7d7d99460e695"
        "5e8bcb177571c7196de58ff28c381913e7c82d0adfd90c45ca")),
    ("main.c XTS256", _MAIN_KEY + _MAIN_SECOND_KEY, _MAIN_IVEC, _MAIN_PLAINTEXT, hex2bytes(
        "40bfcc14845b1bb415dd13abf1e6f89d3bfd794cf6655ffd14c0d7e4177eeaf4"
        "5dd95f05663fcfb447671154a91b9d00d1bd7a35c14c74109a")),
)

# OCB (RFC 7253): (name, key, nonce, aad, pt, ct || tag).  main.c's OCB128
# (the first 16 bytes of CIPHER_KEY, the first 12 of IVEC, the AAD and
# plaintext of the GCM-SIV vector above) and the RFC 7253 appendix A sample
# with 24 bytes of AAD and plaintext.
_RFC7253_AAD = hex2bytes("000102030405060708090A0B0C0D0E0F1011121314151617")
OCB_VECTORS = (
    ("main.c OCB128", _MAIN_KEY[:16], _MAIN_IVEC[:12], _MAIN_AAD, _MAIN_PLAINTEXT, hex2bytes(
        "fc254896eb785b05dd87f240722dd93561f5a0ef6aff2eb65953da0b26257ed0"
        "d69cb496e9a0cb1bf646151aa07e629a28d99f0ffd7ea7535c39f440df33c988"
        "c55cbcc8ac086ffa23")),
    ("RFC 7253 24-byte", hex2bytes("000102030405060708090A0B0C0D0E0F"),
     hex2bytes("BBAA99887766554433221107"), _RFC7253_AAD, _RFC7253_AAD, hex2bytes(
         "1CA2207308C87C010756104D8840CE1952F09673A448A122"
         "C92C62241051F57356D7F3C90BB0E07F")),
)

# The SP 800-38A modes and CMAC of main.c (main.c:31-86): the first 16 bytes
# of CIPHER_KEY as the key (24 for ECB192, with PKCS#7 padding), IVEC as the
# iv (its first 12 bytes as the CTR nonce), the 57 bytes of PLAINTEXT as the
# data; CBC128_CTS ends in ciphertext stealing, CBC128_PAD0 pads with zeros.
MAIN_KEY, MAIN_IV, MAIN_PLAINTEXT = _MAIN_KEY, _MAIN_IVEC, _MAIN_PLAINTEXT
ECB128 = hex2bytes(
    "5d00c273f8b2607da834632dcbb521f4697dd4ab20bb064532a6545e24e33ae9"
    "f545176111f93773dbecd262841cf83b10d145e71b772cf7a12889cda84be795"
)
ECB192 = hex2bytes(
    "af1893f0fbb09a437f6b0fd4f49778907bb85cccf1e9d2e3ebe5bae935107868"
    "c6d72cb2ca375c12ce6b6b1141141fd0d268d14db351d6805aabb99427341da9"
)
CBC128_CTS = hex2bytes(
    "65c48fdf9fbd626128f2d8bac3f7125175e7f4821fda026370011632779d7403"
    "c119ef461ac4e1bc8a7e36bf92b3b3d17E9E2D298E154BC42D"
)
CBC128_PAD0 = hex2bytes(
    "65c48fdf9fbd626128f2d8bac3f7125175e7f4821fda026370011632779d7403"
    "7E9E2D298E154BC42Dc7a9bc419b915dc119ef461ac4e1bc8a7e36bf92b3b3d1"
)
CFB128 = hex2bytes(
    "edab3105e673bc9eb9102539a9f457bc245c14e1bff81b5b4a4a147c988cb0a6"
    "3f9c56525efbe64a876ad1d761d3fc9359fb4f5b2354acd490"
)
OFB128 = hex2bytes(
    "edab3105e673bc9eb9102539a9f457bcd28c8e4c92995f5cd9426926be1e775d"
    "e22b8ce4d0278b18181b8bec93b9726f959aa5d701d46102f0"
)
CTR128 = hex2bytes(
    "6c6bae886c235d8c7997d45c1bf0bca248b4bca9eb396d1bf6945e5b7a4fc10f"
    "488cfe76fd5eaeff2b8fb469f78fa61e285e4cf9b9aee3d0a8"
)
CMAC128 = hex2bytes("b887df1fd8c239c3e8a64d9822e21128")

# The one-pass AEAD chains (main.c:31-86, inputs as above): CCM128 with the
# first 11 bytes of IVEC as its nonce, EAX128 with all 16, EAXP128 with the
# AAD as the EAX' nonce data (ct || 4-byte mac), and SIV128 (iv || ct) under
# the whole 32-byte CIPHER_KEY as K1 || K2.
MAIN_AAD = _MAIN_AAD
CCM128 = hex2bytes(
    "d2575123438338d70b2955537fdfcf41729870884e85af15f0a74975a72b337d"
    "04d426de87594b9abe3e6dcf07f21c99db3999f81299d302ad1e5ba683e9039a"
    "5483685f1bd2c3fa3b"
)
EAX128 = hex2bytes(
    "4e2fa1bef9ffc23f6965ee7135981c91af9bfe97a6b13c01b8b99e114dda2391"
    "50661c618335a00547cca55a8f22fbd5ed5ab4b4a17d0aa329febd14ef271bae"
    "986810a504f01ec602"
)
EAXP128 = hex2bytes(
    "f516e9c20069292cc51ba8b6403ddedf5a34798f62187f58d723fa33573fd80b"
    "f08ffbb09dadbd0b6fa4812ca4bb5e6ddb9a384943b36690e81738a7a1"
)
SIV128 = hex2bytes(
    "ff2537a371fba0bbed11acf2a363130097964f088881bdbdf163e261afd158e6"
    "09272e759213c76aedc83a451d094c9e06e2600e50a27cbbc0d9fad10eb6d369"
    "4614362e5cd68b90a9"
)

# RFC 5297 appendix A.1 (deterministic AES-SIV, one AAD):
# (keys K1 || K2, aad, pt, iv || ct)
SIV_RFC5297 = (
    hex2bytes("fffefdfcfbfaf9f8f7f6f5f4f3f2f1f0f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff"),
    hex2bytes("101112131415161718191a1b1c1d1e1f2021222324252627"),
    hex2bytes("112233445566778899aabbccddee"),
    hex2bytes("85632d07c6e8f37f950acd320a2ecc9340c02b9690c4dc04daef7f6afe5c"),
)

# EAX' (IEEE Std 1703): (name, key, nonce data, pt, ct || mac).  Annex G of
# IEEE Std 1703-2012 (an empty payload, main.c:322-333) and the
# Moise-Beroset-Phinney-Burns paper's vector (main.c:334-348).
EAXP_VECTORS = (
    ("IEEE 1703 annex G", hex2bytes("01020304050607080102030405060708"),
     hex2bytes("A20D060B607C86F7540116007BC175A803020100BE0D280B810984A60C060A60"
               "7C86F7540116007B040248F3C20403300005"), b"", hex2bytes("515AE775")),
    ("MBPB paper", hex2bytes("102030405060708090a0b0c0d0e0f000"),
     hex2bytes("a20e060c6086480186fc2f811caa4e01a806020439a00ebbac0fa20da00ba109"
               "80010081044bcee2c3be252823812188a60a06082b06010401828563004bcee2c3"),
     hex2bytes("1751" + "30" * 20 + "000003300001"),
     hex2bytes("9cf32c7ec24c250be7b0749feee71a220d0eee976ec23dbf0caa08ea00543e66")),
)

# RFC 3394 key wrap (main.c:22-29, 252-257): the KEK is the first 16, 24 or
# all 32 bytes of SECRET_KEY and the secret as many bytes of SECOND_KEY; the
# AES-256 answer is RFC 3394's section 4.6 vector.
KW_KEK = hex2bytes("000102030405060708090A0B0C0D0E0F101112131415161718191A1B1C1D1E1F")
KW_SECRET = hex2bytes("00112233445566778899AABBCCDDEEFF000102030405060708090A0B0C0D0E0F")
KW128 = hex2bytes("1FA68B0A8112B447AEF34BD8FB5A7B829D3E862371D2CFE5")
KW192 = hex2bytes("031D33264E15D33268F24EC260743EDCE1C6C7DDEE725A936BA814915C6762D2")
KW256 = hex2bytes(
    "28C9F404C4B810F4CBCCB35CFB87F8263F5786E2D80ED326CBC7F0E71A99F43B"
    "FB988B9B7A02DD21"
)
# (key length, wrapped answer): KEK = KW_KEK[:klen], secret = KW_SECRET[:klen]
KW_VECTORS = ((16, KW128), (24, KW192), (32, KW256))
