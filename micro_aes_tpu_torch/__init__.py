"""micro_aes_tpu_torch — the PyTorch/CUDA port of micro_aes_tpu for NVIDIA
Hopper (H100).

It carries AES-GCM three ways, with CTR, and AES-GCM-SIV two ways:

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
    and length), plain PyTorch.

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
from .modes.ctr import ctr_decrypt, ctr_encrypt
from .modes.gcm import gcm_decrypt, gcm_encrypt
from .modes.gcm_siv import gcm_siv_decrypt, gcm_siv_encrypt
from .modes.seal import ctr_bulk, gcm_key_setup, gcm_open, gcm_seal
from .modes.seal_batch import gcm_open_batch, gcm_seal_batch
from .modes.siv_seal import gcm_siv_open, gcm_siv_seal
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
]
