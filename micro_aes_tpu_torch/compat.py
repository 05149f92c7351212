"""C-style compatibility layer: the reference's exact function surface.

Every `AES_*` function below mirrors its counterpart in micro_aes.h (names,
argument order, buffer-with-appended-tag conventions, and numeric return
codes, including the `0x1L` == 1 quirk), over the port's per-message modes.
Use this layer when porting code from the C library verbatim; the pythonic
API of `micro_aes_tpu_torch` proper is preferred for new code.

Fallible functions return (code, output) instead of writing through
pointers; infallible ones (void in C) return output alone.  Each takes the
port's keyword-only `device=` after its C arguments ("cuda" unless the
caller asks for the CPU).
"""
from __future__ import annotations

import numpy as np

from . import modes
from .errors import MicroAesError, ResultCode
from .fpe import fpe_decrypt, fpe_encrypt
from .modes.common import dec_blocks_np, enc_blocks_np

M_RESULT_SUCCESS = int(ResultCode.SUCCESS)
M_ENCRYPTION_ERROR = int(ResultCode.ENCRYPTION_ERROR)
M_DECRYPTION_ERROR = int(ResultCode.DECRYPTION_ERROR)
M_AUTHENTICATION_ERROR = int(ResultCode.AUTHENTICATION_ERROR)
M_DATALENGTH_ERROR = int(ResultCode.DATALENGTH_ERROR)


def _guard(fn, *args, **kwargs):
    try:
        return M_RESULT_SUCCESS, fn(*args, **kwargs)
    except MicroAesError as e:
        return int(e.code), b""


def AES_Cipher(key, mode, block, *, device="cuda"):
    """micro_aes.h:163: mode 'E' (or 1) encrypts one block, anything else
    decrypts it."""
    if not len(bytes(block)):  # no block at all, as the reference's to_blocks
        return b""
    x = np.frombuffer(bytes(block)[:16].ljust(16, b"\0"), np.uint8).reshape(1, 16)
    enc = (isinstance(mode, str) and mode.upper() == "E") or mode == 1
    return bytes((enc_blocks_np if enc else dec_blocks_np)(bytes(key), x, device).reshape(-1))


def AES_ECB_encrypt(key, pntxt, *, device="cuda"):
    return modes.ecb_encrypt(key, pntxt, device=device)


def AES_ECB_decrypt(key, crtxt, *, device="cuda"):
    return _guard(modes.ecb_decrypt, key, crtxt, device=device)


def AES_CBC_encrypt(key, iVec, pntxt, *, device="cuda"):
    return _guard(modes.cbc_encrypt, key, iVec, pntxt, device=device)


def AES_CBC_decrypt(key, iVec, crtxt, *, device="cuda"):
    return _guard(modes.cbc_decrypt, key, iVec, crtxt, device=device)


def AES_CFB_encrypt(key, iVec, pntxt, *, device="cuda"):
    return modes.cfb_encrypt(key, iVec, pntxt, device=device)


def AES_CFB_decrypt(key, iVec, crtxt, *, device="cuda"):
    return modes.cfb_decrypt(key, iVec, crtxt, device=device)


def AES_OFB_encrypt(key, iVec, pntxt, *, device="cuda"):
    return modes.ofb_encrypt(key, iVec, pntxt, device=device)


def AES_OFB_decrypt(key, iVec, crtxt, *, device="cuda"):
    return modes.ofb_decrypt(key, iVec, crtxt, device=device)


def AES_CTR_encrypt(key, iv, pntxt, *, device="cuda"):
    return modes.ctr_encrypt(key, iv, pntxt, device=device)


def AES_CTR_decrypt(key, iv, crtxt, *, device="cuda"):
    return modes.ctr_decrypt(key, iv, crtxt, device=device)


def AES_XTS_encrypt(keys, tweak, pntxt, *, device="cuda"):
    return _guard(modes.xts_encrypt, keys, tweak, pntxt, device=device)


def AES_XTS_decrypt(keys, tweak, crtxt, *, device="cuda"):
    return _guard(modes.xts_decrypt, keys, tweak, crtxt, device=device)


def AES_SIV_encrypt(keys, aData, pntxt, *, device="cuda"):
    """Returns (iv, crtxt) like the two output buffers of micro_aes.h:273."""
    return modes.siv_encrypt(keys, aData, pntxt, device=device)


def AES_SIV_decrypt(keys, iv, aData, crtxt, *, device="cuda"):
    return _guard(modes.siv_decrypt, keys, iv, aData, crtxt, device=device)


def AES_GCM_encrypt(key, nonce, aData, pntxt, *, device="cuda"):
    return modes.gcm_encrypt(key, nonce, aData, pntxt, device=device)


def AES_GCM_decrypt(key, nonce, aData, crtxt_with_tag, *, device="cuda"):
    return _guard(modes.gcm_decrypt, key, nonce, aData, crtxt_with_tag, device=device)


def AES_CCM_encrypt(key, nonce, aData, pntxt, *, device="cuda"):
    return modes.ccm_encrypt(key, nonce, aData, pntxt, device=device)


def AES_CCM_decrypt(key, nonce, aData, crtxt_with_tag, *, device="cuda"):
    return _guard(modes.ccm_decrypt, key, nonce, aData, crtxt_with_tag, device=device)


def AES_OCB_encrypt(key, nonce, aData, pntxt, *, device="cuda"):
    return modes.ocb_encrypt(key, nonce, aData, pntxt, device=device)


def AES_OCB_decrypt(key, nonce, aData, crtxt_with_tag, *, device="cuda"):
    return _guard(modes.ocb_decrypt, key, nonce, aData, crtxt_with_tag, device=device)


def AES_EAX_encrypt(key, nonce, aData, pntxt, *, device="cuda"):
    return modes.eax_encrypt(key, nonce, aData, pntxt, device=device)


def AES_EAX_decrypt(key, nonce, aData, crtxt_with_tag, *, device="cuda"):
    return _guard(modes.eax_decrypt, key, nonce, aData, crtxt_with_tag, device=device)


def GCM_SIV_encrypt(key, nonce, aData, pntxt, *, device="cuda"):
    return modes.gcm_siv_encrypt(key, nonce, aData, pntxt, device=device)


def GCM_SIV_decrypt(key, nonce, aData, crtxt_with_tag, *, device="cuda"):
    return _guard(modes.gcm_siv_decrypt, key, nonce, aData, crtxt_with_tag, device=device)


def AES_KEY_wrap(kek, secret, *, device="cuda"):
    return _guard(modes.key_wrap, kek, secret, device=device)


def AES_KEY_unwrap(kek, wrapped, *, device="cuda"):
    return _guard(modes.key_unwrap, kek, wrapped, device=device)


def AES_Poly1305(keys, nonce, data, *, device="cuda"):
    return modes.poly1305_aes(keys, nonce, data, device=device)


def AES_CMAC(key, data, *, device="cuda"):
    return modes.cmac(key, data, device=device)


def AES_FPE_encrypt(key, tweak, pntxt, alphabet="digits", method="ff1", *, device="cuda"):
    return _guard(fpe_encrypt, key, tweak, pntxt, alphabet, method, device=device)


def AES_FPE_decrypt(key, tweak, crtxt, alphabet="digits", method="ff1", *, device="cuda"):
    return _guard(fpe_decrypt, key, tweak, crtxt, alphabet, method, device=device)
