#!/usr/bin/env python3
"""K13 (the lane-packed serial chains of micro_aes_tpu_torch) of one checkout
on one NVIDIA GPU, for comparing two checkouts on the same card.

Times CBC, CFB and OFB at AES-256 and the masked CBC-MAC at AES-128 (nvalid
0..256) on chip_smoke.py's phase-7 shape, 4096 messages x 256 blocks with a
random key per message, with CUDA events: five means of 10 launches after a
warm-up.  Prints one JSON line with the checkout, the card's nvidia-smi line,
the times and a SHA-256 of each output, so two checkouts that agree bit for
bit print the same digests.  Run each checkout in its own process, in an
order such as A, B, B, A:

    python3 tools/k13_ab.py [CHECKOUT_ROOT]    # default: this repository
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

B, NB, SEED = 4096, 256, 13


def cuda_ms(fn, reps: int = 10) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parent.parent)
    sys.path.insert(0, str(root.resolve()))
    from micro_aes_tpu_torch.core.bitslice import key_planes_packed
    from micro_aes_tpu_torch.modes.bulk import stack_round_keys
    from micro_aes_tpu_torch.ops import chain_kernels as ck
    from micro_aes_tpu_torch.utils.bytesio import u32_tensor

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    ivs = torch.from_numpy(rng.integers(0, 256, (B, 16), dtype=np.uint8)).to(dev)
    blocks = torch.from_numpy(rng.integers(0, 256, (B, NB, 16), dtype=np.uint8)).to(dev)
    nv = rng.integers(0, NB + 1, B).astype(np.int32)
    nvalid = torch.from_numpy(nv).to(dev)
    kpw = {klen: u32_tensor(key_planes_packed(stack_round_keys(
        [rng.integers(0, 256, klen, dtype=np.uint8).tobytes() for _ in range(B)])), dev)
        for klen in (16, 32)}
    cases = {
        "cbc": lambda: ck.chain_packed_fused("cbc", kpw[32], ivs, blocks),
        "cfb": lambda: ck.chain_packed_fused("cfb", kpw[32], ivs, blocks),
        "ofb": lambda: ck.ofb_packed_fused(kpw[32], ivs, NB),
        "cbcmac": lambda: ck.cbcmac_packed_fused(kpw[16], ivs, blocks, nvalid),
    }
    ms, digest = {}, {}
    for name, fn in cases.items():
        digest[name] = hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest()[:16]
        ms[name] = [cuda_ms(fn) for _ in range(5)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"checkout": str(root), "nvidia_smi": smi.strip().splitlines()[0],
                      "shape": [B, NB], "ms": ms, "sha256": digest}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
