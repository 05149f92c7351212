"""AES-OCB (RFC 7253), parity with micro_aes.c:1655-1813.

The reference recomputes each Δ_i from scratch (getDelta, c:1662-1680);
here the offsets come from the gray-code identity
    Δ_i = Δ_0 ^ XOR_{b set in gray(i)} L_b,   gray(i) = i ^ (i >> 1),
so the whole offset table is a vectorized bit-select and the body is one
batched cipher call on the requested device.  Plain PyTorch on either
device: the bulk engine (modes/ocb_bulk) is the kernel path, and this
module is its oracle.
"""
from __future__ import annotations

import numpy as np

from ..core.cipher import encrypt_blocks_np
from ..errors import AuthenticationError, DataLengthError
from ..ops.mac import double_be_np
from ..utils.bytesio import BLOCK, to_u8, verify_tag
from ..utils.keycache import key_cache
from .common import dec_blocks_np, enc_blocks_np

OCB_NONCE_LEN = 12
OCB_TAG_LEN = 16
_MAX_L = 48  # messages of up to 2^48 blocks


@key_cache(maxsize=256)
def _subkeys(key: bytes):
    """L_* = E(0), L_$ = 2·L_*, L_i = 2·L_{i-1} (getSubkeys with quad=0 and
    the doubling ladder), host numpy, read-only."""
    l_star = encrypt_blocks_np(key, np.zeros((1, BLOCK), np.uint8))[0]
    l_dollar = double_be_np(l_star)
    ls = np.zeros((_MAX_L, BLOCK), np.uint8)
    ls[0] = double_be_np(l_dollar)
    for i in range(1, _MAX_L):
        ls[i] = double_be_np(ls[i - 1])
    for a in (l_star, l_dollar, ls):
        a.setflags(write=False)
    return l_star, l_dollar, ls


def _offsets(ls: np.ndarray, delta0: np.ndarray, n: int) -> np.ndarray:
    """Δ_i for i = 1..n by the gray-code bit-select, vectorized."""
    if n == 0:
        return np.zeros((0, BLOCK), np.uint8)
    i = np.arange(1, n + 1, dtype=np.uint64)
    gray = i ^ (i >> 1)
    nbits = max(1, int(gray.max()).bit_length())
    sel = ((gray[:, None] >> np.arange(nbits, dtype=np.uint64)) & 1).astype(np.uint8)
    f = np.zeros((n, BLOCK), np.uint8)
    for b in range(nbits):  # xor in the selected L_b
        f ^= sel[:, b: b + 1] * ls[b]
    return f ^ delta0


def gray_delta(ls: np.ndarray, delta0: np.ndarray, n: int) -> np.ndarray:
    """Δ_n alone: Δ_0 ^ XOR of L_b over the set bits b of gray(n)."""
    delta = delta0.copy()
    gray = n ^ (n >> 1)
    for b in range(gray.bit_length()):
        if (gray >> b) & 1:
            delta ^= ls[b]
    return delta


def _offset0(key: bytes, nonce: np.ndarray, tag_len: int, device) -> np.ndarray:
    """Ktop, stretch and Δ_0 (micro_aes.c:1703-1719, RFC 7253 §4.2)."""
    if not 1 <= len(nonce) <= 15:  # RFC 7253 §4.2: a 1..120-bit nonce
        raise DataLengthError("OCB nonce must be 1..15 bytes")
    kt = np.zeros(BLOCK, np.uint8)
    kt[BLOCK - len(nonce):] = nonce
    kt[0] |= (tag_len << 4) & 0xFF
    kt[BLOCK - 1 - len(nonce)] |= 1
    bottom = int(kt[BLOCK - 1] & 0x3F)
    kt[BLOCK - 1] &= 0xC0
    ktop = enc_blocks_np(key, kt[None], device)[0]
    stretch = np.concatenate([ktop, ktop[:8] ^ ktop[1:9]])
    s = int.from_bytes(bytes(stretch), "big")
    off = (s >> (64 - bottom)) & ((1 << 128) - 1)
    return np.frombuffer(off.to_bytes(16, "big"), np.uint8).copy()


def pmac_aad(key: bytes, aad: np.ndarray, ls, l_star, device) -> np.ndarray:
    """PMAC over the AAD (micro_aes.c:1746-1760), its offsets from zero."""
    an, ar = len(aad) // BLOCK, len(aad) % BLOCK
    acc = np.zeros(BLOCK, np.uint8)
    a_offs = _offsets(ls, np.zeros(BLOCK, np.uint8), an)
    if an:
        ab = aad[: an * BLOCK].reshape(an, BLOCK)
        acc ^= np.bitwise_xor.reduce(enc_blocks_np(key, ab ^ a_offs, device), axis=0)
    if ar:
        delta_an = a_offs[-1] if an else np.zeros(BLOCK, np.uint8)
        last = np.zeros(BLOCK, np.uint8)
        last[:ar] = aad[an * BLOCK:]
        last[ar] ^= 0x80
        acc ^= enc_blocks_np(key, (delta_an ^ l_star ^ last)[None], device)[0]
    return acc


def ocb_tail(key: bytes, tail: np.ndarray, delta_n: np.ndarray, l_star, encrypt: bool,
             device):
    """The partial last block (micro_aes.c:1731-1738) -> (its output, the
    plaintext tail, Δ_*)."""
    if not len(tail):
        return tail, tail, delta_n
    pad = enc_blocks_np(key, (l_star ^ delta_n)[None], device)[0]
    out = tail ^ pad[: len(tail)]
    return out, (tail if encrypt else out), delta_n ^ l_star


def ocb_tag(key: bytes, checksum: np.ndarray, pt_tail: np.ndarray, delta_star, l_dollar,
            pmac: np.ndarray, device) -> np.ndarray:
    """The full 16-byte tag from the checksum of the plaintext's whole
    blocks: the tail joins zero-padded with its 0x80 marker."""
    checksum = checksum.copy()
    r = len(pt_tail)
    if r:
        checksum[:r] ^= pt_tail
        checksum[r] ^= 0x80
    return enc_blocks_np(key, (checksum ^ delta_star ^ l_dollar)[None], device)[0] ^ pmac


def _ocb_core(key: bytes, nonce, aad, data: np.ndarray, encrypt: bool, tag_len: int,
              device) -> tuple[bytes, np.ndarray]:
    """OCB_cipher (micro_aes.c:1693-1762) -> (output, full 16-byte tag)."""
    nonce, aad = to_u8(nonce), to_u8(aad)
    l_star, l_dollar, ls = _subkeys(key)
    delta0 = _offset0(key, nonce, tag_len, device)

    n = len(data) // BLOCK
    offs = _offsets(ls, delta0, n)
    cipher = enc_blocks_np if encrypt else dec_blocks_np
    body_in = data[: n * BLOCK].reshape(n, BLOCK)
    body_out = cipher(key, body_in ^ offs, device) ^ offs if n else body_in
    delta_n = offs[-1] if n else delta0
    tail_out, tail_pt, delta_star = ocb_tail(key, data[n * BLOCK:], delta_n, l_star, encrypt,
                                             device)
    # the checksum is over the PLAINTEXT
    checksum = np.bitwise_xor.reduce(body_in if encrypt else body_out, axis=0,
                                     initial=0)
    tag = ocb_tag(key, checksum, tail_pt, delta_star, l_dollar,
                  pmac_aad(key, aad, ls, l_star, device), device)
    return body_out.tobytes() + tail_out.tobytes(), tag


def ocb_encrypt(key, nonce, aad, plaintext, tag_len: int = OCB_TAG_LEN, *,
                device="cuda") -> bytes:
    """AES_OCB_encrypt (micro_aes.c:1774-1784) -> ciphertext || tag."""
    ct, tag = _ocb_core(bytes(key), nonce, aad, to_u8(plaintext), True, tag_len, device)
    return ct + bytes(tag[:tag_len])


def ocb_decrypt(key, nonce, aad, ct_and_tag, tag_len: int = OCB_TAG_LEN, *,
                device="cuda") -> bytes:
    """AES_OCB_decrypt (micro_aes.c:1797-1813): decrypt, then verify in
    constant time; raises AuthenticationError on a mismatch."""
    data = to_u8(ct_and_tag)
    ct, tag = data[: len(data) - tag_len], data[len(data) - tag_len:]
    pt, full_tag = _ocb_core(bytes(key), nonce, aad, ct, False, tag_len, device)
    if not verify_tag(full_tag[:tag_len], tag):
        raise AuthenticationError("OCB tag mismatch")
    return pt
