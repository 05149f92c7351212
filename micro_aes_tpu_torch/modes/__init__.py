"""Modes of operation: the reference's per-message surface (SURVEY §2.3).
The bulk and batch engines live in their own modules (seal, seal_batch,
siv_seal, xts_bulk, ocb_bulk, chain_bulk, bulk)."""
from .cbc import cbc_decrypt, cbc_encrypt
from .ccm import ccm_decrypt, ccm_encrypt
from .cfb import cfb_decrypt, cfb_encrypt
from .cmac import cmac
from .ctr import ctr_decrypt, ctr_encrypt
from .eax import eax_decrypt, eax_encrypt, eaxp_decrypt, eaxp_encrypt
from .ecb import ecb_decrypt, ecb_encrypt
from .gcm import gcm_decrypt, gcm_encrypt
from .gcm_siv import gcm_siv_decrypt, gcm_siv_encrypt
from .kw import key_unwrap, key_wrap
from .ocb import ocb_decrypt, ocb_encrypt
from .ofb import ofb_decrypt, ofb_encrypt
from .poly1305 import poly1305_aes
from .siv import siv_decrypt, siv_encrypt
from .xts import xts_decrypt, xts_encrypt

__all__ = [
    "cbc_decrypt", "cbc_encrypt", "ccm_decrypt", "ccm_encrypt",
    "cfb_decrypt", "cfb_encrypt", "cmac", "ctr_decrypt", "ctr_encrypt",
    "eax_decrypt", "eax_encrypt", "eaxp_decrypt", "eaxp_encrypt",
    "ecb_decrypt", "ecb_encrypt", "gcm_decrypt", "gcm_encrypt",
    "gcm_siv_decrypt", "gcm_siv_encrypt", "key_unwrap", "key_wrap",
    "ocb_decrypt", "ocb_encrypt", "ofb_decrypt", "ofb_encrypt",
    "poly1305_aes", "siv_decrypt", "siv_encrypt", "xts_decrypt",
    "xts_encrypt",
]
