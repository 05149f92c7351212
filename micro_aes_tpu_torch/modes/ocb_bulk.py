"""Bulk AES-OCB (RFC 7253): the parallel body that the reference itself
advertises (micro_aes.c:1653, "independent calculation of the offset
blocks") as one kernel, K7 (ops/xex_kernels.ocb_fused).

The body C_i = Δ_i ^ E_K(P_i ^ Δ_i) runs on the w-major stream with the
offsets made inside the kernel from the gray-code select (no offset table
in device memory); the open direction uses the inverse cipher.  The
checksum (the XOR of the plaintext's whole blocks) is a reduction over the
plaintext stream on the device; Δ_0, Δ_n, the ragged tail block, the tag
block and PMAC over the AAD are single blocks of the byte cipher
(modes/ocb).  The open verifies the tag before any plaintext is returned
(the body's stream stays on the device until then).

Every public entry point takes `device=` ("cuda" unless the caller asks for
the CPU): K7 on CUDA, its plain version on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.bitslice import key_planes
from ..core.keyschedule import expand_key
from ..errors import AuthenticationError
from ..ops.mac import xor_reduce
from ..ops.seal_kernels import SEAL_WORD_ALIGN
from ..ops.xex_kernels import ocb_fused
from ..utils.bytesio import BLOCK, to_u8, u32_tensor, verify_tag
from ..utils.keycache import key_cache
from .ocb import OCB_TAG_LEN, _offset0, _subkeys, gray_delta, ocb_tag, ocb_tail, pmac_aad
from .seal import _from_device_stream, _to_device_stream


def _lane_words(blocks: np.ndarray) -> np.ndarray:
    """uint8[..., 16] -> lane-replicated uint32[..., 128]: lane l holds
    little-endian word l % 4."""
    words = np.ascontiguousarray(blocks, np.uint8).view(np.uint32)
    return np.tile(words, 32)


@key_cache(maxsize=64)
def _ocb_key_setup(key: bytes, device: torch.device):
    """Per-key state: the key planes [(R+1)*128, 1], the host subkeys L_*,
    L_$ and L_0..L_47, and the L_b as lane words int32[48, 128] (K7's
    table) on `device`."""
    l_star, l_dollar, ls = _subkeys(key)
    return ocb_state_from_jax(key_planes(expand_key(key)).reshape(-1, 1), l_star, l_dollar,
                              ls, device=device)


def ocb_state_from_jax(kp_flat, l_star, l_dollar, ls, *, device="cuda"):
    """The JAX package's per-key OCB state (as numpy: `_ocb_key_setup`'s key
    planes and `_subkeys`) -> the port's (kp_flat, l_star, l_dollar, ls,
    lbl) with the tensors on `device`, so that both packages run on one
    state."""
    dev = torch.device(device)
    ls = np.asarray(ls, np.uint8)
    return (u32_tensor(kp_flat, dev), np.asarray(l_star, np.uint8),
            np.asarray(l_dollar, np.uint8), ls, u32_tensor(_lane_words(ls), dev))


def _ocb_bulk_core(key: bytes, nonce, aad, data: bytes, encrypt: bool, tag_len: int, device):
    """-> (the body's output stream on the device or None, the tail's
    output bytes, the full 16-byte tag)."""
    nonce, aad = to_u8(nonce), to_u8(aad)
    kp, l_star, l_dollar, ls, lbl = _ocb_key_setup(key, device)
    delta0 = _offset0(key, nonce, tag_len, device)

    n = len(data) // BLOCK
    out, checksum = None, np.zeros(BLOCK, np.uint8)
    if n:
        w = -(-n // 32)
        w += (-w) % SEAL_WORD_ALIGN
        nbits = max(1, (32 * w).bit_length())
        stream = _to_device_stream(data[: n * BLOCK], 0, w, device)
        out = ocb_fused(kp, u32_tensor(_lane_words(delta0)[None], device), lbl[:nbits], stream,
                        nbits, decrypt=not encrypt)
        # the checksum is over the PLAINTEXT's n whole blocks
        pt_words = (stream if encrypt else out).reshape(-1)[: 4 * n]
        checksum = xor_reduce(pt_words.view(torch.int64).reshape(n, 2)).cpu().numpy().view(np.uint8)
    tail_out, tail_pt, delta_star = ocb_tail(key, np.frombuffer(data[n * BLOCK:], np.uint8),
                                             gray_delta(ls, delta0, n), l_star, encrypt, device)
    tag = ocb_tag(key, checksum, tail_pt, delta_star, l_dollar,
                  pmac_aad(key, aad, ls, l_star, device), device)
    return out, tail_out.tobytes(), tag


def _body_bytes(out, n_bytes: int) -> bytes:
    return _from_device_stream(out, 0, n_bytes) if out is not None else b""


def ocb_seal(key, nonce, aad, plaintext, tag_len: int = OCB_TAG_LEN, *, device="cuda") -> bytes:
    """Bulk OCB encrypt -> ciphertext || tag; the body on K7.  Nonces of
    1..15 bytes, any AAD and message length."""
    pt = bytes(to_u8(plaintext))
    out, tail, tag = _ocb_bulk_core(bytes(key), nonce, aad, pt, True, tag_len,
                                    torch.device(device))
    return _body_bytes(out, len(pt) - len(tail)) + tail + bytes(tag[:tag_len])


def ocb_open(key, nonce, aad, ct_and_tag, tag_len: int = OCB_TAG_LEN, *, device="cuda") -> bytes:
    """Bulk OCB decrypt: the tag is verified (in constant time) before any
    plaintext is returned; raises AuthenticationError on a mismatch."""
    data = bytes(to_u8(ct_and_tag))
    ct, tag = data[: len(data) - tag_len], data[len(data) - tag_len:]
    out, tail, full_tag = _ocb_bulk_core(bytes(key), nonce, aad, ct, False, tag_len,
                                         torch.device(device))
    if not verify_tag(full_tag[:tag_len], tag):
        raise AuthenticationError("OCB tag mismatch")
    return _body_bytes(out, len(ct) - len(tail)) + tail
