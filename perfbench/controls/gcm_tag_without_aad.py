"""AES-GCM records whose tag leaves the additional data out: the record
header (sequence number, type, version, length) unauthenticated, the step a
shortcut around the AAD fold would take.  Ciphertexts stay right; every tag
of a record with a header differs."""
from __future__ import annotations

from ..reference import gcm


def gcm_seal_batch(keys, nonces, aads, pts, tag_len: int = 16, *, device="cuda"):
    return gcm.seal(keys, nonces, [b""] * len(keys), pts, device=device)


def gcm_open_batch(keys, nonces, aads, ct_tags, tag_len: int = 16, *, device="cuda"):
    return gcm.open_(keys, nonces, [b""] * len(keys), ct_tags, device=device)
