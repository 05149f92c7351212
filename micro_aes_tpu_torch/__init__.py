"""micro_aes_tpu_torch — the PyTorch/CUDA port of micro_aes_tpu for NVIDIA
Hopper (H100).

It carries AES-GCM three ways (with CTR), and AES-GCM-SIV, XTS and OCB two
ways each (in bulk and per message):

  * the single-key bulk path: `gcm_seal` / `gcm_open` and bulk CTR
    (`ctr_bulk`), on K1 (fused seal/open body with in-kernel level-1
    GHASH), K2 (bitsliced plane cipher) and K3 (fused CTR keystream);
  * the multi-key batch path: `gcm_seal_batch` / `gcm_open_batch`, a key
    per message, on K10 (the lane-packed GCM chain) and, for ragged
    batches, K9 (the multi-key cipher);
  * the per-message API: `gcm_encrypt` / `gcm_decrypt` (any nonce length,
    short tags) and `ctr_encrypt` / `ctr_decrypt`, plain PyTorch;
  * GCM-SIV (RFC 8452) in bulk: `gcm_siv_seal` / `gcm_siv_open` (12-byte
    nonce, whole blocks, no AAD), on K4 (level-1 POLYVAL of the stream)
    and K5 (CTR from in-kernel LE32 counters; its open form also folds the
    level-1 POLYVAL of the recovered plaintext);
  * GCM-SIV per message: `gcm_siv_encrypt` / `gcm_siv_decrypt` (any AAD
    and length), plain PyTorch;
  * XTS disk sectors in bulk: `xts_seal_sectors` / `xts_open_sectors`
    (whole sectors, integer LBAs or tweak blocks), on K6 (the XEX body
    with the offsets base·α^j expanded in the kernel) for sectors of a
    multiple of 512 bytes and on K2 otherwise; XTS per message:
    `xts_encrypt` / `xts_decrypt` (ciphertext stealing, bit-granular data
    units), plain PyTorch;
  * OCB (RFC 7253) in bulk: `ocb_seal` / `ocb_open`, on K7 (the XEX body
    with gray-code offsets made in the kernel); per message:
    `ocb_encrypt` / `ocb_decrypt`, plain PyTorch.  K8 (`ops/xex_kernels.
    ctrw_fused`, the cipher-and-xor of a caller's block stream, on K3's
    body) is on no path yet;
  * the serial-chain modes per message: `ecb_*`, `cbc_*` (CS3 stealing or
    padding), `cfb_*` and `ofb_*` encrypt/decrypt and `cmac`: the chains
    (CBC/CFB encrypt, the OFB keystream, the CBC-MAC) on K13 (the
    lane-packed chain kernel) as a batch of one message, the parallel
    directions on the byte cipher; in batches (modes/chain_bulk, and
    `cmac_batch` / `xts_batch` in modes/bulk), many messages under as many
    keys, the chains on K13 and the parallel directions on K9 (one launch
    of each per call, two of K9 for CBC-CTS decrypt);
  * the one-pass AEAD chains per message: `ccm_*`, `eax_*`, `eaxp_*` (EAX')
    and `siv_*` encrypt/decrypt, their MACs on K13 as a batch of one
    message and their CTR bodies on the byte cipher; in batches
    (modes/bulk `ccm_*_batch`, `eax_*_batch`, `siv_*_batch`), many messages
    under as many keys, each direction K11 (CCM, EAX) or K12 (SIV) per key
    size: the keystream pass on K15 (the lane-packed CTR) and the MAC chain
    alone on K13's CBC-MAC with the last-step constants;
  * RFC 3394 key wrap per message: `key_wrap` / `key_unwrap`, the 6n-step
    wheel on K16 (ops/kw_kernels) as a batch of one message; in batches
    (modes/bulk `key_wrap_batch` / `key_unwrap_batch`), many secrets under
    as many KEKs, one K16 launch per call (the ragged entry, ops/ragged).
    K14 (K13's chains in the wide message map, ops/chain_kernels
    `chain_packed_fused_wide` / `ofb_packed_fused_wide`) and K16's wide map
    (`kw_packed_fused`) are on no path;
  * Poly1305-AES: `poly1305_aes` (modes/poly1305), a Horner loop of host
    ints below 64 KiB and, at or above it, the whole chunks folded on the
    device as float64 products over powers of r (ops/poly_bulk);
  * format-preserving encryption: `fpe_encrypt` / `fpe_decrypt` (FF1, FF3
    and FF3-1 over the `ALPHABETS` registry or any `Alphabet`), one token
    at a time, FF1's PRF on K13 and FF3's on the byte cipher; in batches
    (fpe/device `fpe_encrypt_batch` / `fpe_decrypt_batch` and the digit-
    matrix `fpe_*_digits`), the Feistel rounds over all tokens of one
    length at once with every batched PRF encrypt on K2;
  * the reference's C surface (`compat`): the `AES_*` functions with the C
    names, argument order, tag-appended buffers and result codes.

The kernels are hand-written CUDA in csrc/.  Every entry point runs on the
card unless it is given `device="cpu"`; on the CPU the kernels' plain
PyTorch versions run.  The JAX package `micro_aes_tpu` is the reference it
is held against.
"""

__version__ = "0.1.0"

from .core.cipher import aes_cipher, decrypt_blocks, encrypt_blocks
from .core.keyschedule import expand_key
from .errors import (
    AuthenticationError,
    DataLengthError,
    DecryptionError,
    EncryptionError,
    MicroAesError,
    ResultCode,
)
from .fpe import ALPHABETS, Alphabet, fpe_decrypt, fpe_encrypt
from .fpe import device as _fpe_device  # noqa: F401  (registers its key caches)
from .modes.cbc import cbc_decrypt, cbc_encrypt
from .modes.ccm import ccm_decrypt, ccm_encrypt
from .modes.cfb import cfb_decrypt, cfb_encrypt
from .modes.cmac import cmac
from .modes.ctr import ctr_decrypt, ctr_encrypt
from .modes.eax import eax_decrypt, eax_encrypt, eaxp_decrypt, eaxp_encrypt
from .modes.ecb import ecb_decrypt, ecb_encrypt
from .modes.gcm import gcm_decrypt, gcm_encrypt
from .modes.gcm_siv import gcm_siv_decrypt, gcm_siv_encrypt
from .modes.kw import key_unwrap, key_wrap
from .modes.ocb import ocb_decrypt, ocb_encrypt
from .modes.ocb_bulk import ocb_open, ocb_seal
from .modes.ofb import ofb_decrypt, ofb_encrypt
from .modes.poly1305 import poly1305_aes
from .modes.seal import ctr_bulk, gcm_key_setup, gcm_open, gcm_seal
from .modes.seal_batch import gcm_open_batch, gcm_seal_batch
from .modes.siv import siv_decrypt, siv_encrypt
from .modes.siv_seal import gcm_siv_open, gcm_siv_seal
from .modes.xts import xts_decrypt, xts_encrypt
from .modes.xts_bulk import xts_open_sectors, xts_seal_sectors
from .utils.keycache import purge_key_caches

__all__ = [
    "__version__",
    "purge_key_caches",
    "aes_cipher", "encrypt_blocks", "decrypt_blocks", "expand_key",
    "ResultCode", "MicroAesError", "EncryptionError", "DecryptionError",
    "AuthenticationError", "DataLengthError",
    "gcm_seal", "gcm_open", "ctr_bulk", "gcm_key_setup",
    "gcm_encrypt", "gcm_decrypt", "ctr_encrypt", "ctr_decrypt",
    "gcm_seal_batch", "gcm_open_batch",
    "gcm_siv_seal", "gcm_siv_open", "gcm_siv_encrypt", "gcm_siv_decrypt",
    "xts_encrypt", "xts_decrypt", "xts_seal_sectors", "xts_open_sectors",
    "ocb_encrypt", "ocb_decrypt", "ocb_seal", "ocb_open",
    "ecb_encrypt", "ecb_decrypt", "cbc_encrypt", "cbc_decrypt",
    "cfb_encrypt", "cfb_decrypt", "ofb_encrypt", "ofb_decrypt", "cmac",
    "ccm_encrypt", "ccm_decrypt", "eax_encrypt", "eax_decrypt",
    "eaxp_encrypt", "eaxp_decrypt", "siv_encrypt", "siv_decrypt",
    "key_wrap", "key_unwrap", "poly1305_aes",
    "fpe_encrypt", "fpe_decrypt", "Alphabet", "ALPHABETS",
]
