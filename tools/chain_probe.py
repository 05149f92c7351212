#!/usr/bin/env python3
"""The serial-chain layer of the PyTorch/CUDA port (micro_aes_tpu_torch) on
one NVIDIA GPU: how K13's time scales with the batch, and where the time of
a warm 4096 x 4 KiB chain request goes.

1. K13's step loops in SASS (cuobjdump of the built library, counted by
   tools/spread_ab.kernel_loops): instructions by class per step, per kind
   and key size.
2. K13 (ops/chain_kernels) alone, CUDA events, mean of 10 after a warm-up:
   OFB and CBC at 256 blocks per message for B = 64 .. 16,384 messages,
   AES-128 and AES-256, a random key per message.  A time that does not grow
   with B says the kernel is bound by the latency of its serial steps, not
   by the card's throughput.
3. Warm requests at 4096 messages x 4 KiB (cbc_encrypt_batch and
   cbc_decrypt_batch, cfb_encrypt_batch and ofb_xcrypt_batch at AES-256,
   cmac_batch at AES-128): host-clock seconds per call, device time by
   kernel and the device's busy share of the call (torch.profiler).

    python3 tools/chain_probe.py
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_batch_profile import profile_call  # noqa: E402


def cuda_ms(fn, reps: int = 10) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def round_loops() -> dict:
    """The SHFL loops of each K13 kind (spread_ab.kernel_loops), from
    cuobjdump of the built library."""
    from spread_ab import kernel_loops

    from micro_aes_tpu_torch.ops import _build

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(_build.build())], capture_output=True,
                          text=True, check=True).stdout
    kinds = {"ILi0E": "cbc", "ILi1E": "cfb", "ILi2E": "ofb", "ILi3E": "cbc-mac"}
    out = {}
    for func in re.split(r"\n\s*Function : ", sass):
        name = func.split("\n", 1)[0]
        for tag, kind in kinds.items():
            if "chain_packed_kernel" in name and tag in name:
                out[kind] = {k: {c: v[c] for c in ("total", "lop3", "shfl")}
                             for k, v in kernel_loops(func).items()}
    return out


def kernel_scaling(dev, rng, nb: int = 256) -> list[dict]:
    from micro_aes_tpu_torch.core.bitslice import key_planes_packed
    from micro_aes_tpu_torch.modes.bulk import stack_round_keys
    from micro_aes_tpu_torch.ops import chain_kernels as ck
    from micro_aes_tpu_torch.utils.bytesio import u32_tensor

    rows = []
    for b in (64, 1024, 4096, 16384):
        ivs = torch.from_numpy(rng.integers(0, 256, (b, 16), dtype=np.uint8)).to(dev)
        blocks = torch.from_numpy(rng.integers(0, 256, (b, nb, 16), dtype=np.uint8)).to(dev)
        for klen in (16, 32):
            keys = [rng.integers(0, 256, klen, dtype=np.uint8).tobytes() for _ in range(b)]
            kpw = u32_tensor(key_planes_packed(stack_round_keys(keys)), dev)
            rows.append({"messages": b, "blocks": nb, "key_bits": 8 * klen,
                         "ofb_ms": cuda_ms(lambda: ck.ofb_packed_fused(kpw, ivs, nb)),
                         "cbc_ms": cuda_ms(lambda: ck.chain_packed_fused("cbc", kpw, ivs, blocks))})
    return rows


def warm_requests(rng, b: int = 4096, size: int = 4096) -> dict:
    from micro_aes_tpu_torch.modes import bulk
    from micro_aes_tpu_torch.modes import chain_bulk as cb

    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    blob = rand(b * size)
    pts = [blob[i * size:(i + 1) * size] for i in range(b)]
    keys256, keys128, ivs = [rand(32) for _ in range(b)], [rand(16) for _ in range(b)], \
        [rand(16) for _ in range(b)]
    cts = cb.cbc_encrypt_batch(keys256, ivs, pts)
    calls = {"cbc_encrypt_batch": lambda: cb.cbc_encrypt_batch(keys256, ivs, pts),
             "cbc_decrypt_batch": lambda: cb.cbc_decrypt_batch(keys256, ivs, cts),
             "cfb_encrypt_batch": lambda: cb.cfb_encrypt_batch(keys256, ivs, pts),
             "ofb_xcrypt_batch": lambda: cb.ofb_xcrypt_batch(keys256, ivs, pts),
             "cmac_batch": lambda: bulk.cmac_batch(keys128, pts)}
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
        print("chain_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    rng = np.random.default_rng(0)
    print("K13 loops", json.dumps(round_loops()))
    for row in kernel_scaling(dev, rng):
        print("K13", json.dumps(row))
    for name, row in warm_requests(rng).items():
        print("request", name, json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
