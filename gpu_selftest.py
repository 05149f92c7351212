#!/usr/bin/env python3
"""On-card selftest of the PyTorch/CUDA port (micro_aes_tpu_torch): the 27
checks of tpu_selftest.py, in the same order on the same seeded inputs,
through the port's APIs, on an NVIDIA GPU.  Two tiers:

  1. KAT anchor: examples/demo_torch.py in a subprocess runs the
     per-message APIs on the card against the reference's embedded main.c
     known answers (testing/kat.py).
  2. Differentials: every bulk and batch engine (GCM seal/open, CTR, OCB,
     XTS sectors, GCM-SIV, the Poly1305 fold, the multi-key GCM, SIV, CCM,
     EAX and chain batches, batched FPE) against the KAT-anchored
     per-message path on random inputs.

    python3 gpu_selftest.py [--device cuda|cpu] [--out SELFTEST.json]

It runs on the card unless `--device cpu` is given; without a GPU it
prints why and exits 2, running nothing.  Exit 0 = all green.  With
`--out` the per-check record is also written there as JSON.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

DEMO = Path(__file__).resolve().parent / "examples" / "demo_torch.py"
DEMO_TIMEOUT_S = 600


def run_demo(device) -> subprocess.CompletedProcess:
    """examples/demo_torch.py on `device` (the card, or --cpu) in a
    subprocess, under DEMO_TIMEOUT_S."""
    import torch

    flags = ["--cpu"] if torch.device(device).type == "cpu" else []
    return subprocess.run([sys.executable, str(DEMO), *flags], capture_output=True,
                          text=True, timeout=DEMO_TIMEOUT_S)


def run_checks(device="cuda", demo: subprocess.CompletedProcess | None = None,
               log=print) -> list[tuple[str, bool]]:
    """The 27 checks on `device` -> [(name, ok)], each also logged as a JSON
    line.  `demo` is a finished run_demo(device) to take the KAT sweep's
    result from; without it the demo runs here."""
    import torch

    dev = torch.device(device)
    results: list[tuple[str, bool]] = []

    def check(name: str, ok: bool):
        results.append((name, bool(ok)))
        log(json.dumps({"check": name, "ok": bool(ok)}))

    # -- tier 1: KAT anchor (per-message APIs on the device vs main.c answers) --
    if demo is None:
        demo = run_demo(dev)
    check("KAT sweep (examples/demo_torch.py)",
          demo.returncode == 0 and "FAILED" not in demo.stdout)
    if demo.returncode != 0:
        sys.stderr.write(demo.stdout + demo.stderr)

    # -- tier 2: bulk engines vs the KAT-anchored per-message path --
    rng = np.random.default_rng(7)
    key = bytes(range(32))
    key16 = key[:16]
    nonce = bytes(rng.integers(0, 256, 12, dtype=np.uint8))
    aad = bytes(rng.integers(0, 256, 37, dtype=np.uint8))
    pt = bytes(rng.integers(0, 256, 4096 * 16, dtype=np.uint8))

    from micro_aes_tpu_torch.modes.gcm import gcm_decrypt, gcm_encrypt
    from micro_aes_tpu_torch.modes.seal import ctr_bulk, gcm_open, gcm_seal

    expect = gcm_encrypt(key, nonce, aad, pt, device=dev)
    sealed = gcm_seal(key, nonce, pt, aad=aad, device=dev)
    check("fused GCM seal == per-message GCM", sealed == expect)
    check("fused GCM open round-trip", gcm_open(key, nonce, sealed, aad=aad, device=dev) == pt)
    check("per-message GCM open (verify-first)",
          gcm_decrypt(key, nonce, aad, expect, device=dev) == pt)

    from micro_aes_tpu_torch.modes.ctr import ctr_encrypt

    iv = nonce + bytes(4)
    check("fused CTR == per-message CTR",
          ctr_bulk(key, nonce, pt, device=dev) == ctr_encrypt(key, iv, pt, device=dev))

    from micro_aes_tpu_torch.modes.ocb import ocb_encrypt
    from micro_aes_tpu_torch.modes.ocb_bulk import ocb_open, ocb_seal

    oc = ocb_seal(key16, nonce, aad, pt, device=dev)
    check("fused OCB seal == per-message OCB",
          oc == ocb_encrypt(key16, nonce, aad, pt, device=dev))
    check("fused OCB open round-trip",
          ocb_open(key16, nonce, aad, oc, device=dev) == pt)

    from micro_aes_tpu_torch.modes.xts import xts_encrypt
    from micro_aes_tpu_torch.modes.xts_bulk import xts_open_sectors, xts_seal_sectors

    xkey = bytes(range(64))[:32]
    sector, nsec = 4096, 16
    data = bytes(rng.integers(0, 256, sector * nsec, dtype=np.uint8))
    ids = list(range(100, 100 + nsec))
    xs = xts_seal_sectors(xkey, ids, data, sector_size=sector, device=dev)
    per = b"".join(
        xts_encrypt(xkey, sid.to_bytes(16, "little"),
                    data[i * sector:(i + 1) * sector], device=dev)
        for i, sid in enumerate(ids))
    check("fused XTS sectors == per-sector XTS", xs == per)
    check("fused XTS open round-trip",
          xts_open_sectors(xkey, ids, xs, sector_size=sector, device=dev) == data)

    from micro_aes_tpu_torch.modes.gcm_siv import gcm_siv_encrypt
    from micro_aes_tpu_torch.modes.siv_seal import gcm_siv_open, gcm_siv_seal

    gs = gcm_siv_seal(key, nonce, pt, device=dev)
    check("fused GCM-SIV seal == per-message",
          gs == gcm_siv_encrypt(key, nonce, b"", pt, device=dev))
    check("fused GCM-SIV open round-trip", gcm_siv_open(key, nonce, gs, device=dev) == pt)

    from micro_aes_tpu_torch.modes.poly1305 import poly1305_aes, poly1305_aes_bulk

    # as in tpu_selftest.py: the 64 KiB message is at the routing threshold,
    # so poly1305_aes folds it on the device too
    pkeys = bytes(range(32))
    pnonce = bytes(range(16))
    check("bulk Poly1305 == host fold",
          poly1305_aes_bulk(pkeys, pnonce, pt, device=dev)
          == poly1305_aes(pkeys, pnonce, pt, device=dev))

    from micro_aes_tpu_torch.modes.seal_batch import gcm_open_batch, gcm_seal_batch

    bkeys = [bytes(rng.integers(0, 256, 16, dtype=np.uint8))
             for _ in range(8)]
    bnonces = [bytes(rng.integers(0, 256, 12, dtype=np.uint8))
               for _ in range(8)]
    baads = [bytes(rng.integers(0, 256, i, dtype=np.uint8))
             for i in range(8)]
    bpts = [bytes(rng.integers(0, 256, 16 * (1 + 37 * i), dtype=np.uint8))
            for i in range(8)]
    bres = gcm_seal_batch(bkeys, bnonces, baads, bpts, device=dev)
    check("multi-key GCM batch == per-message GCM",
          all(bres[i] == gcm_encrypt(bkeys[i], bnonces[i], baads[i], bpts[i], device=dev)
              for i in range(8)))
    check("multi-key GCM open round-trip",
          gcm_open_batch(bkeys, bnonces, baads, bres, device=dev) == bpts)

    # large messages force the value-chain engine's L>1 segmentation
    # (right-aligned virtual lanes + power-table combine)
    spts = [bytes(rng.integers(0, 256, 65536, dtype=np.uint8))
            for _ in range(4)]
    sres = gcm_seal_batch(bkeys[:4], bnonces[:4], baads[:4], spts, device=dev)
    check("segmented value-chain GCM (64 KB msgs) == per-message GCM",
          all(sres[i] == gcm_encrypt(bkeys[i], bnonces[i], baads[i],
                                     spts[i], device=dev) for i in range(4)))

    from micro_aes_tpu_torch.modes.bulk import siv_decrypt_batch, siv_encrypt_batch
    from micro_aes_tpu_torch.modes.siv import siv_encrypt

    vkeys = [bytes(rng.integers(0, 256, 32, dtype=np.uint8))
             for _ in range(8)]
    vres = siv_encrypt_batch(vkeys, baads, bpts, device=dev)
    check("fused SIV batch seal == per-message SIV",
          all(vres[i] == siv_encrypt(vkeys[i], baads[i], bpts[i], device=dev)
              for i in range(8)))
    check("fused SIV batch open round-trip",
          siv_decrypt_batch(vkeys, [iv for iv, _ in vres], baads,
                            [ct for _, ct in vres], device=dev) == bpts)

    from micro_aes_tpu_torch.modes.bulk import ccm_encrypt_batch, eax_encrypt_batch
    from micro_aes_tpu_torch.modes.ccm import ccm_encrypt
    from micro_aes_tpu_torch.modes.eax import eax_encrypt

    cnonces = [n[:11] for n in bnonces]
    cres = ccm_encrypt_batch(bkeys, cnonces, baads, bpts, device=dev)
    check("device-resident CCM batch == per-message CCM",
          all(cres[i] == ccm_encrypt(bkeys[i], cnonces[i], baads[i], bpts[i], device=dev)
              for i in range(8)))
    eres = eax_encrypt_batch(bkeys, bnonces, baads, bpts, device=dev)
    check("device-resident EAX batch == per-message EAX",
          all(eres[i] == eax_encrypt(bkeys[i], bnonces[i], baads[i], bpts[i], device=dev)
              for i in range(8)))

    from micro_aes_tpu_torch.modes.cbc import cbc_encrypt
    from micro_aes_tpu_torch.modes.chain_bulk import cbc_encrypt_batch, ofb_xcrypt_batch
    from micro_aes_tpu_torch.modes.ofb import ofb_encrypt

    ckeys = [bytes(rng.integers(0, 256, 32, dtype=np.uint8))
             for _ in range(48)]
    civs = [bytes(rng.integers(0, 256, 16, dtype=np.uint8))
            for _ in range(48)]
    cpts = [bytes(rng.integers(0, 256, 16 * (2 + i), dtype=np.uint8))
            for i in range(48)]
    got = cbc_encrypt_batch(ckeys, civs, cpts, device=dev)
    check("chain kernel CBC batch == per-message CBC",
          all(got[i] == cbc_encrypt(ckeys[i], civs[i], cpts[i], device=dev)
              for i in range(48)))
    got = ofb_xcrypt_batch(ckeys, civs, cpts, device=dev)
    check("OFB keystream kernel == per-message OFB",
          all(got[i] == ofb_encrypt(ckeys[i], civs[i], cpts[i], device=dev)
              for i in range(48)))

    from micro_aes_tpu_torch.fpe import fpe_encrypt
    from micro_aes_tpu_torch.fpe.device import (
        fpe_decrypt_batch,
        fpe_decrypt_digits,
        fpe_encrypt_batch,
        fpe_encrypt_digits,
    )

    toks = ["".join("0123456789"[d] for d in rng.integers(0, 10, 16))
            for _ in range(64)]
    enc = fpe_encrypt_batch(key16, b"\x01\x02", toks, "digits", "ff1", device=dev)
    check("device FF1 batch == host FF1",
          enc[:4] == [fpe_encrypt(key16, b"\x01\x02", t, "digits", "ff1", device=dev)
                      for t in toks[:4]])
    check("device FF1 round-trip",
          fpe_decrypt_batch(key16, b"\x01\x02", enc, "digits", "ff1", device=dev) == toks)

    dmat = rng.integers(0, 10, (64, 16), dtype=np.uint8)
    dct = fpe_encrypt_digits(key16, b"\x01\x02", dmat, 10, "ff1", device=dev)
    dtoks = ["".join("0123456789"[v] for v in row) for row in dmat]
    check("digit-array FF1 == string batch",
          ["".join("0123456789"[v] for v in row) for row in dct]
          == fpe_encrypt_batch(key16, b"\x01\x02", dtoks, "digits", "ff1", device=dev))
    check("digit-array FF1 round-trip",
          np.array_equal(fpe_decrypt_digits(key16, b"\x01\x02", dct, 10, "ff1", device=dev),
                         dmat))

    tw7 = bytes(range(7))
    d3 = fpe_encrypt_digits(key16, tw7, dmat, 10, "ff3-1", device=dev)
    check("digit-array FF3-1 == host FF3-1",
          "".join("0123456789"[v] for v in d3[5])
          == fpe_encrypt(key16, tw7, dtoks[5], "digits", "ff3-1", device=dev))
    check("digit-array FF3-1 round-trip",
          np.array_equal(fpe_decrypt_digits(key16, tw7, d3, 10, "ff3-1", device=dev), dmat))
    return results


def _write_record(path: str, payload: dict) -> None:
    payload = {"ts": round(time.time()), "cmd": "python3 gpu_selftest.py", **payload}
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda",
                        help="torch device the checks run on (default cuda)")
    parser.add_argument("--out", help="write the per-check record here as JSON")
    args = parser.parse_args(argv)

    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        reason = "torch.cuda.is_available() is False; pass --device cpu to run on the CPU"
        print(json.dumps({"selftest": "skipped", "reason": reason}))
        if args.out:
            _write_record(args.out, {"selftest": "skipped", "device": str(dev), "reason": reason})
        return 2

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    results = run_checks(dev)
    n_fail = sum(1 for _, ok in results if not ok)
    print(json.dumps({"selftest": "done", "device": name,
                      "passed": len(results) - n_fail, "failed": n_fail}))
    if args.out:
        _write_record(args.out, {
            "selftest": "done", "device": name,
            "passed": len(results) - n_fail, "failed": n_fail,
            "checks": [{"name": n, "ok": ok} for n, ok in results]})
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
