#!/usr/bin/env python3
"""The one-pass AEAD layer of the PyTorch/CUDA port (micro_aes_tpu_torch) on
one NVIDIA GPU: how K11's and K12's times scale with the batch beside K13's
CBC-MAC, and where the time of a warm CCM, EAX or SIV batch request goes.

1. K11 (CCM seal, EAX open), K12 (SIV seal and open) and K13's masked
   CBC-MAC (ops/aead_kernels, ops/chain_kernels) alone, CUDA events, mean of
   10 after a warm-up: 256 blocks per message, every message whole (nvalid =
   256), AES-128, a random key per message, for B = 64 .. 16,384 messages.
   A time that does not grow with B says a kernel is bound by the latency of
   its serial steps; the ratio to K13 says what a step costs beside K13's.
2. Warm requests: ccm_*_batch and eax_*_batch at 2048 x 4 KiB and
   siv_*_batch at 4096 x 4 KiB (AES-128, AAD b"hdr"): host-clock seconds per
   call, device time by kernel and the device's busy share of the call
   (torch.profiler).

    python3 tools/aead_chain_probe.py
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from chain_probe import cuda_ms  # noqa: E402
from torch_batch_profile import profile_call  # noqa: E402


def kernel_scaling(dev, rng, nb: int = 256) -> list[dict]:
    from micro_aes_tpu_torch.core.bitslice import key_planes_packed
    from micro_aes_tpu_torch.modes.bulk import stack_round_keys
    from micro_aes_tpu_torch.ops import aead_kernels as ak
    from micro_aes_tpu_torch.ops.chain_kernels import cbcmac_packed_fused
    from micro_aes_tpu_torch.utils.bytesio import u32_tensor

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    rows = []
    for b in (64, 1024, 4096, 16384):
        kpw, kpc = (u32_tensor(key_planes_packed(stack_round_keys(
            [rng.integers(0, 256, 16, dtype=np.uint8).tobytes() for _ in range(b)])), dev)
            for _ in range(2))
        c0, init, tail, lastadd, prevadd, blocks = (u8(b, 16), u8(b, 16), u8(b, 16), u8(b, 16),
                                                    u8(b, 16), u8(b, nb, 16))
        nvalid = torch.full((b,), nb, dtype=torch.int32, device=dev)
        rows.append({
            "messages": b, "blocks": nb, "key_bits": 128,
            "k13_cbcmac_ms": cuda_ms(lambda: cbcmac_packed_fused(kpw, init, blocks, nvalid)),
            "k11_ccm_seal_ms": cuda_ms(lambda: ak.aead_chain_fused(
                "ccm", kpw, c0, init, blocks, nvalid, tail, lastadd, False)),
            "k11_eax_open_ms": cuda_ms(lambda: ak.aead_chain_fused(
                "eax", kpw, c0, init, blocks, nvalid, tail, lastadd, True)),
            "k12_seal_ms": cuda_ms(lambda: ak.siv_seal_chain_fused(
                kpw, kpc, init, blocks, nvalid, tail, lastadd, prevadd)),
            "k12_open_ms": cuda_ms(lambda: ak.siv_open_chain_fused(
                kpw, kpc, c0, init, blocks, nvalid, tail, lastadd, prevadd))})
    return rows


def warm_requests(rng, size: int = 4096) -> dict:
    from micro_aes_tpu_torch.modes import bulk

    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    b, bs = 2048, 4096
    blob = rand(bs * size)
    pts = [blob[i * size:(i + 1) * size] for i in range(bs)]
    keys, nonces, aads = [rand(16) for _ in range(b)], [rand(12) for _ in range(b)], [b"hdr"] * b
    siv_keys = [rand(32) for _ in range(bs)]
    ccm = bulk.ccm_encrypt_batch(keys, [n[:11] for n in nonces], aads, pts[:b])
    eax = bulk.eax_encrypt_batch(keys, nonces, aads, pts[:b])
    siv = bulk.siv_encrypt_batch(siv_keys, [b"hdr"] * bs, pts)
    calls = {
        "ccm_encrypt_batch": lambda: bulk.ccm_encrypt_batch(keys, [n[:11] for n in nonces], aads,
                                                            pts[:b]),
        "ccm_decrypt_batch": lambda: bulk.ccm_decrypt_batch(keys, [n[:11] for n in nonces], aads,
                                                            ccm),
        "eax_encrypt_batch": lambda: bulk.eax_encrypt_batch(keys, nonces, aads, pts[:b]),
        "eax_decrypt_batch": lambda: bulk.eax_decrypt_batch(keys, nonces, aads, eax),
        "siv_encrypt_batch": lambda: bulk.siv_encrypt_batch(siv_keys, [b"hdr"] * bs, pts),
        "siv_decrypt_batch": lambda: bulk.siv_decrypt_batch(
            siv_keys, [s[0] for s in siv], [b"hdr"] * bs, [s[1] for s in siv]),
    }
    out = {}
    for name, fn in calls.items():
        fn()  # warm: kernels built, caches filled
        wall, by_name, launches = profile_call(fn)
        busy = sum(by_name.values()) / 1e6
        top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:4])
        out[name] = {"host_s": wall, "device_s": busy, "busy_share": busy / wall,
                     "device_launches": launches, "top_kernels_us": top}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("aead_chain_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    rng = np.random.default_rng(0)
    for row in kernel_scaling(dev, rng):
        print("K11/K12", json.dumps(row))
    for name, row in warm_requests(rng).items():
        print("request", name, json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
