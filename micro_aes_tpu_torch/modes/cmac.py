"""AES-CMAC (NIST SP 800-38B), parity with micro_aes.c:1100-1117."""
from __future__ import annotations

from .common import cmac_digest


def cmac(key, data, *, device="cuda") -> bytes:
    """AES_CMAC: the 16-byte MAC of `data` (its CBC-MAC runs through K13)."""
    return bytes(cmac_digest(bytes(key), data, device))
