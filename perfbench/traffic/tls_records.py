"""TLS 1.2 AES-GCM record batches (RFC 5246 §6.2.3.3, RFC 5288 §3).

The deployment holds `connections` long-lived connections, each with its
own key and 4-byte salt and a 64-bit sequence number that starts at a
random point.  Every call carries one record of each connection:

    nonce = salt || seq (8 bytes, big-endian)
    aad   = seq || type (1) || version (2) || plaintext length (2)

and the sequence numbers advance by one every call, so no nonce repeats.
The mix's `ops` cycle call by call.  An "open" call opens the records that
the "seal" call before it produced (the connection's peer is this host
itself), with one record in each `tamper_every` given a flipped tag bit: it
has to come back None.  Record lengths are `record_bytes`: one number, or
[lo, hi] for lengths spread evenly over lo..hi, the same set for every
seed, in an order drawn from the seed.
"""
from __future__ import annotations

import numpy as np

from ..reference import gcm
from . import Call

BLOCK = 16
TAG = 16


def _split(blob: bytes, lens) -> list[bytes]:
    ends = np.cumsum(lens)
    return [blob[e - n:e] for n, e in zip(lens, ends)]


class Traffic:
    def __init__(self, config: dict, mix: dict, seed: int):
        self.n = n = config["connections"]
        self.klen = config["key_bytes"]
        self.header = bytes([config["record_type"], *config["version"]])
        self.ops = mix["ops"]
        self.tamper_every = mix.get("tamper_every", 0)
        self.seed = seed
        self.prev_seal = None
        rng = np.random.default_rng([seed, 0])
        self.keys = _split(rng.bytes(n * self.klen), [self.klen] * n)
        self.salts = rng.integers(0, 256, (n, 4), dtype=np.uint8)
        self.seq0 = rng.integers(0, 1 << 62, n, dtype=np.uint64)
        lens = mix["record_bytes"]
        if isinstance(lens, int):
            base = np.full(n, lens, np.int64)
        else:
            lo, hi = lens
            base = lo + ((np.arange(n) + 0.5) * (hi - lo + 1) / n).astype(np.int64)
        self.pool = []
        for _ in range(mix["pool_batches"]):
            rec = rng.permutation(base)
            self.pool.append(_split(rng.bytes(int(rec.sum())), rec.tolist()))

    def _headers(self, i: int, lens) -> tuple[list[bytes], list[bytes]]:
        seq = (self.seq0 + np.uint64(i)).astype(">u8").view(np.uint8).reshape(self.n, 8)
        nonce = np.concatenate([self.salts, seq], 1).tobytes()
        aad = np.zeros((self.n, 13), np.uint8)
        aad[:, :8] = seq
        aad[:, 8:11] = np.frombuffer(self.header, np.uint8)
        aad[:, 11:] = np.asarray(lens, ">u2").view(np.uint8).reshape(self.n, 2)
        aad = aad.tobytes()
        return ([nonce[12 * k:12 * k + 12] for k in range(self.n)],
                [aad[13 * k:13 * k + 13] for k in range(self.n)])

    def _work(self, lens) -> dict:
        nblocks = sum(-(-x // BLOCK) for x in lens)
        return {"aes": [(10, False, nblocks + self.n)],
                "ghash_blocks": nblocks + 2 * self.n,  # data, the AAD block, the length block
                "bytes": 2 * sum(lens) + self.n * (12 + 13 + TAG + self.klen)}

    def _seal(self, keys, i: int, pts) -> Call:
        lens = [len(p) for p in pts]
        nonces, aads = self._headers(i, lens)
        return Call("gcm_seal_batch", (keys, nonces, aads, pts), sum(lens), self._work(lens),
                    {"op": "seal"})

    def call(self, i: int, last) -> Call:
        op = self.ops[i % len(self.ops)]
        prev = self.prev_seal
        if op == "open" and (prev is None or not isinstance(last, list) or len(last) != self.n
                             or not all(isinstance(x, bytes) and len(x) == len(p) + TAG
                                        for x, p in zip(last, prev.args[3]))):
            op = "seal"  # nothing of the right shape to open: the seal before failed
        if op == "seal":
            call = self._seal(self.keys, i, self.pool[(i // len(self.ops)) % len(self.pool)])
            self.prev_seal = call
            return call
        keys, nonces, aads, pts = prev.args
        rng = np.random.default_rng([self.seed, 1, i])
        flips = {}
        if self.tamper_every:
            for g in range(0, self.n, self.tamper_every):
                k = g + int(rng.integers(0, min(self.tamper_every, self.n - g)))
                flips[k] = (len(last[k]) - TAG + int(rng.integers(0, TAG)), 1 << int(rng.integers(0, 8)))
        data = list(last)
        for k, (pos, bit) in flips.items():
            b = bytearray(data[k])
            b[pos] ^= bit
            data[k] = bytes(b)
        lens = [len(p) for p in pts]
        return Call("gcm_open_batch", (keys, nonces, aads, data), sum(lens), self._work(lens),
                    {"op": "open", "pts": pts, "sealed": last, "flips": flips})

    def cold_call(self, j: int) -> Call:
        rng = np.random.default_rng([self.seed, 2, j])
        keys = _split(rng.bytes(self.n * self.klen), [self.klen] * self.n)
        return self._seal(keys, j, self.pool[0])

    def check(self, call: Call, out, device) -> tuple[int, int]:
        """Seal: every record's ct || tag equals the reference's.  Open:
        every genuine record comes back as the plaintext that was sealed,
        every tampered one as None, and the sealed records that were opened
        equal the reference's seal of that plaintext."""
        keys, nonces, aads, data = call.args
        if not isinstance(out, list) or len(out) != self.n:
            return self.n, self.n
        if call.expect["op"] == "seal":
            ref = gcm.seal(keys, nonces, aads, data, device=device)
            return self.n, sum(o != r for o, r in zip(out, ref))
        pts, sealed, flips = call.expect["pts"], call.expect["sealed"], call.expect["flips"]
        ref = gcm.seal(keys, nonces, aads, pts, device=device)
        wrong = 0
        for k in range(self.n):
            want = None if k in flips else pts[k]
            wrong += out[k] != want or sealed[k] != ref[k]
        return self.n, wrong
