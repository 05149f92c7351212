"""AES Key Wrap (RFC 3394 / NIST SP 800-38F KW), micro_aes.c:1820-1894.

The 6n-step wheel is strictly serial.  On the card one message runs as lane 0
of a 32-message word through K16 (ops/kw_kernels.kw_packed), one launch per
call, the way modes/common.chain_np runs a chain on K13; on the CPU the
kernel's plain version runs.
"""
from __future__ import annotations

import numpy as np
import torch

from ..errors import AuthenticationError, DataLengthError
from ..ops.kw_kernels import HB, ICV, kw_packed
from ..utils.bytesio import to_u8, verify_tag
from .common import one_key_planes


def _wheel(kek: bytes, data: np.ndarray, unwrap: bool, device) -> np.ndarray:
    """One message's wheel over host semiblocks uint8[n,8] (wrap) or
    uint8[n+1,8] (unwrap) -> host uint8[n+1,8], A || R."""
    kpw = one_key_planes(bytes(kek), device)
    buf = torch.zeros((32,) + data.shape, dtype=torch.uint8, device=kpw.device)
    buf[0] = torch.from_numpy(data)
    return kw_packed(kpw, buf, unwrap)[0].cpu().numpy()


def key_wrap(kek, secret, *, device="cuda") -> bytes:
    """AES_KEY_wrap (micro_aes.c:1829-1855): returns the ICV semiblock ||
    the wrapped secret."""
    secret = to_u8(secret)
    n = len(secret) // HB
    if n < 2 or len(secret) % HB:
        raise DataLengthError("KW secret must be >= 2 whole semi-blocks")
    return _wheel(kek, secret.reshape(n, HB).copy(), False, device).tobytes()


def key_unwrap(kek, wrapped, *, device="cuda") -> bytes:
    """AES_KEY_unwrap (micro_aes.c:1865-1894): verifies the 0xA6 ICV."""
    wrapped = to_u8(wrapped)
    n = len(wrapped) // HB
    if n < 3 or len(wrapped) % HB:
        raise DataLengthError("KW input must be >= 3 whole semi-blocks")
    out = _wheel(kek, wrapped.reshape(n, HB).copy(), True, device)
    if not verify_tag(np.full(HB, ICV, np.uint8), out[0]):
        raise AuthenticationError("KW integrity check failed")
    return out[1:].tobytes()
