"""XTS under the nearest smaller key size: each half of the 512-bit volume
key cut to 128 bits (aes-xts-plain64 with --key-size 256), the analogue of
computing in the precision below the one the configuration states."""
from __future__ import annotations

from ..reference import xts


def _cut(keys: bytes) -> bytes:
    half = len(keys) // 2
    return keys[:16] + keys[half:half + 16]


def xts_seal_sectors(keys, sector_ids, data, sector_size: int = 4096, *, device="cuda"):
    return xts.xts(_cut(bytes(keys)), sector_ids, data, sector_size, False, device=device)


def xts_open_sectors(keys, sector_ids, data, sector_size: int = 4096, *, device="cuda"):
    return xts.xts(_cut(bytes(keys)), sector_ids, data, sector_size, True, device=device)
