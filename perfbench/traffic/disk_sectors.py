"""Encrypted-volume I/O: dm-crypt aes-xts-plain64 requests in batches.

A call carries `requests_per_call` requests of `request_bytes` each, at
offsets drawn uniformly from the volume's request-aligned slots, split into
sectors of `sector_size` bytes; each sector's tweak is its sector number
(plain64, counted in sectors of `sector_size`, as LUKS2 does for sectors
above 512 bytes).  A call reads (opens) or writes (seals) all its requests:
of every `cycle` calls, `reads_per_cycle` read, in an order drawn from the
seed, so every seed reads the same share.  Read calls decrypt payload from
the pool as the volume's ciphertext; write calls encrypt it.
"""
from __future__ import annotations

import numpy as np

from ..reference import xts
from . import Call

BLOCK = 16


class Traffic:
    def __init__(self, config: dict, mix: dict, seed: int):
        self.seed = seed
        self.rounds = config["rounds"]
        self.ss = mix["sector_size"]
        self.req = mix["request_bytes"]
        self.nreq = mix["requests_per_call"]
        self.slots = config["volume_bytes"] // self.req
        self.cycle, self.reads = mix["cycle"], mix["reads_per_cycle"]
        rng = np.random.default_rng([seed, 0])
        self.key = rng.bytes(config["key_bytes"])
        self.pool = [rng.bytes(self.nreq * self.req) for _ in range(mix["pool_batches"])]

    def _reads(self, c: int) -> np.ndarray:
        order = np.zeros(self.cycle, bool)
        order[: self.reads] = True
        return np.random.default_rng([self.seed, 1, c]).permutation(order)

    def _call(self, key: bytes, i: int) -> Call:
        c, pos = divmod(i, self.cycle)
        read = bool(self._reads(c)[pos])
        spr = self.req // self.ss
        slots = np.random.default_rng([self.seed, 2, i]).integers(0, self.slots, self.nreq)
        ids = (slots[:, None] * spr + np.arange(spr)[None, :]).reshape(-1).tolist()
        data = self.pool[i % len(self.pool)]
        nsec = len(ids)
        work = {"aes": [(self.rounds, read, len(data) // BLOCK), (self.rounds, False, nsec)],
                "bytes": 2 * len(data) + 8 * nsec + len(key)}
        return Call("xts_open_sectors" if read else "xts_seal_sectors",
                    (key, ids, data, self.ss), len(data), work, {"read": read})

    def call(self, i: int, last) -> Call:
        return self._call(self.key, i)

    def cold_call(self, j: int) -> Call:
        key = np.random.default_rng([self.seed, 3, j]).bytes(len(self.key))
        return self._call(key, j)

    def check(self, call: Call, out, device) -> tuple[int, int]:
        """Every sector equals the reference's."""
        key, ids, data, ss = call.args
        nsec = len(ids)
        if not isinstance(out, bytes) or len(out) != len(data):
            return nsec, nsec
        ref = xts.xts(key, ids, data, ss, call.expect["read"], device=device)
        got = np.frombuffer(out, np.uint8).reshape(nsec, ss)
        want = np.frombuffer(ref, np.uint8).reshape(nsec, ss)
        return nsec, int((got != want).any(1).sum())
