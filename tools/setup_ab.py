#!/usr/bin/env python3
"""A/B of the per-key GHASH/POLYVAL power tables of micro_aes_tpu_torch on
one NVIDIA GPU: the latency of a 16 MiB gcm_siv_seal under a new nonce and
of a 16 MiB gcm_seal under a new key, with the tables built

  torch  by ops/ghash_bulk.ghash_power_tables (float64 products mod 2 on
         the card), and
  numpy  by the host numpy routine that it replaced (reproduced below),

in turns numpy, torch, torch, numpy, every request on a fresh key and
nonce, after one warm-up request.  Both sources must give the same tables
and the same sealed bytes.

    python3 tools/setup_ab.py [--reps N]

Prints, per source, the host-clock seconds of each request and of the
per-(key, nonce) setup alone, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from micro_aes_tpu_torch.modes import seal, siv_seal  # noqa: E402
from micro_aes_tpu_torch.ops import ghash_bulk  # noqa: E402

MIB16 = 16 << 20


def numpy_power_tables(m_h, *, device):
    """The host numpy routine for the per-key tables (same outputs as
    ghash_bulk.ghash_power_tables): 32 + 31 + 2 x 31 128x128 int64
    products, one at a time."""
    c, c2, fan = ghash_bulk.CHUNK, ghash_bulk.CHUNK2, ghash_bulk.SPAN_FAN
    m = np.asarray(m_h, np.uint8).astype(np.int64)

    def mm(a, b):
        return (a @ b) % 2

    def dev(a, dtype=torch.int8):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(device)

    pows = [m]
    for _ in range(c - 1):
        pows.append(mm(m, pows[-1]))
    w1 = np.concatenate([pows[c - 1 - j].T for j in range(c)], axis=0)[ghash_bulk._PLANE_PERM]
    m_c = pows[c - 1]
    pows2 = [np.eye(128, dtype=np.int64), m_c]
    for _ in range(c2 - 2):
        pows2.append(mm(m_c, pows2[-1]))
    w2 = np.concatenate([pows2[c2 - 1 - j].T for j in range(c2)], axis=0)
    m_cur = mm(m_c, pows2[c2 - 1])
    m_outer, spans = m_cur, []
    for _ in range(ghash_bulk.SPAN_LEVELS):
        pws = [np.eye(128, dtype=np.int64), m_cur]
        for _ in range(fan - 2):
            pws.append(mm(m_cur, pws[-1]))
        wsp = np.concatenate([pws[fan - 1 - j].T for j in range(fan)], axis=0)
        m_cur = mm(m_cur, pws[fan - 1])
        spans.append((dev(wsp), dev(m_cur)))
    return (dev(w1), dev(w2), dev(m_outer), dev(np.asarray(m_h, np.uint8), torch.uint8),
            tuple(spans), dev(ghash_bulk.pack_level1(w1.astype(np.int8)), torch.int32))


SOURCES = {"torch": ghash_bulk.ghash_power_tables, "numpy": numpy_power_tables}


def use(source: str) -> None:
    for mod in (seal, siv_seal):
        mod.ghash_power_tables = SOURCES[source]


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3, help="requests per source and turn")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("setup_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    pt = rand(MIB16)
    # the two sources agree, table for table
    m = np.random.default_rng(1).integers(0, 2, (128, 128), dtype=np.uint8)
    a, b = numpy_power_tables(m, device=dev), ghash_bulk.ghash_power_tables(m, device=dev)
    flat = lambda t: [*t[:4], *(x for pair in t[4] for x in pair), t[5]]  # noqa: E731
    if not all(torch.equal(x, y) for x, y in zip(flat(a), flat(b))):
        raise RuntimeError("the two sources disagree")
    use("torch")
    siv_seal.gcm_siv_seal(rand(32), rand(12), pt, device=dev)  # warm-up: build, allocator
    seal.gcm_seal(rand(32), rand(12), pt, device=dev)

    res = {name: {"siv_seal_s": [], "siv_setup_s": [], "gcm_seal_s": []} for name in SOURCES}
    for source in ("numpy", "torch", "torch", "numpy"):
        use(source)
        r = res[source]
        for _ in range(args.reps):
            key, nonce = rand(32), rand(12)
            blob, t = timed(lambda: siv_seal.gcm_siv_seal(key, nonce, pt, device=dev))
            r["siv_seal_s"].append(t)
            siv_seal._siv_key_setup.cache_clear()
            _, t = timed(lambda: siv_seal._siv_key_setup(key, nonce, dev))
            r["siv_setup_s"].append(t)
            use("torch" if source == "numpy" else "numpy")
            siv_seal._siv_key_setup.cache_clear()
            if siv_seal.gcm_siv_seal(key, nonce, pt, device=dev) != blob:
                raise RuntimeError("the two sources seal differently")
            use(source)
            _, t = timed(lambda: seal.gcm_seal(rand(32), rand(12), pt, device=dev))
            r["gcm_seal_s"].append(t)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "request_bytes": MIB16, "seconds": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
