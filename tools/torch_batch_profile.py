#!/usr/bin/env python3
"""Where the time of a warm multi-key batch AES-GCM request goes, for the
PyTorch/CUDA port (micro_aes_tpu_torch) on one NVIDIA GPU.

For each batch shape (keys x bytes per message, AES-128, 13-byte AADs) it
seals once under a new key set and once warm, then profiles one warm seal
and one warm open: host-clock seconds per call, device time by kernel and
the device's busy share of the call (torch.profiler).  The same for a
TLS-record-shaped ragged batch (the K9 engine).  Then it times K10 alone
(CUDA events) at the 1024 x 16 KB batch's chain shape under two lane
targets: the JAX package's 4096 and the port's modes/seal_batch
._CHAIN_LANES.

    python3 tools/torch_batch_profile.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import micro_aes_tpu_torch as aes  # noqa: E402

SHAPES = ((1024, 16 << 10), (4096, 4 << 10), (64, 256 << 10))


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)


def profile_call(fn):
    """(host seconds, device microseconds by kernel name, device launches)
    of one call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, launches = {}, 0
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type.name == "CUDA":
            by_name[evt.key] = by_name.get(evt.key, 0.0) + us
            launches += evt.count
    return wall, by_name, launches


def lane_target_times(dev, rng, b=1024, nb=1024, reps=10):
    """K10 ms (CUDA events, mean of reps) at the chain shape that each lane
    target gives a batch of b messages of nb blocks, AES-128, seal."""
    from micro_aes_tpu_torch.core.bitslice import key_planes_packed
    from micro_aes_tpu_torch.modes import seal_batch
    from micro_aes_tpu_torch.modes.bulk import stack_round_keys
    from micro_aes_tpu_torch.ops.chain import gcm_chain_fused_raw, ghash_halving_table
    from micro_aes_tpu_torch.utils.bytesio import u32_tensor

    out = {}
    for lanes_target in (4096, seal_batch._CHAIN_LANES):
        saved, seal_batch._CHAIN_LANES = seal_batch._CHAIN_LANES, lanes_target
        try:
            bp, s, l = seal_batch._chain_shape(b, nb)
        finally:
            seal_batch._CHAIN_LANES = saved
        lanes = bp * s
        rks = stack_round_keys([rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
                                for _ in range(bp)])

        def u8(*shape):
            return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

        ones = torch.full((l, lanes // 32), -1, dtype=torch.int32, device=dev)
        zeros = torch.zeros_like(ones)
        args = (u32_tensor(key_planes_packed(np.repeat(rks, s, 0)), dev),
                ghash_halving_table(u8(bp, 16).repeat_interleave(s, 0)), u8(lanes, 16),
                u8(lanes, 16), u8(lanes, l, 16), ones, zeros, ones, zeros, u8(lanes, 16),
                u8(lanes, 16))
        gcm_chain_fused_raw(*args)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            gcm_chain_fused_raw(*args)
        end.record()
        torch.cuda.synchronize()
        out[lanes_target] = {"lanes": lanes, "steps": l, "ms": start.elapsed_time(end) / reps}
    return out


def ragged_batch(rng, nrec=256):
    """TLS-record shaped: keys of 16/24/32 bytes in turn, one 8- and one
    60-byte nonce, 13-byte AADs, odd lengths below 2 KiB."""
    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    nonce_lens = [12] * nrec
    nonce_lens[1], nonce_lens[2] = 8, 60
    return ([rand((16, 24, 32)[i % 3]) for i in range(nrec)], [rand(n) for n in nonce_lens],
            [rand(13) for _ in range(nrec)],
            [rand(int(x) | 1) for x in rng.integers(0, 2048, nrec)])


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_batch_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; {smi}; torch {torch.__version__}")
    rng = np.random.default_rng(0)
    batches = []
    for b, size in SHAPES:
        keys = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes() for _ in range(b)]
        nonces = [rng.integers(0, 256, 12, dtype=np.uint8).tobytes() for _ in range(b)]
        aads = [rng.integers(0, 256, 13, dtype=np.uint8).tobytes() for _ in range(b)]
        blob = rng.integers(0, 256, b * size, dtype=np.uint8).tobytes()
        batches.append((f"{b}x{size >> 10}KB", keys, nonces, aads,
                        [blob[i * size:(i + 1) * size] for i in range(b)]))
    batches.append(("ragged TLS x256", *ragged_batch(rng)))
    for name, keys, nonces, aads, pts in batches:  # the first call also builds the kernels
        t0 = time.perf_counter()
        sealed = aes.gcm_seal_batch(keys, nonces, aads, pts, device=dev)
        cold = time.perf_counter() - t0
        aes.gcm_seal_batch(keys, nonces, aads, pts, device=dev)
        for what, fn in (("seal", lambda: aes.gcm_seal_batch(keys, nonces, aads, pts, device=dev)),
                         ("open", lambda: aes.gcm_open_batch(keys, nonces, aads, sealed,
                                                             device=dev))):
            wall, by_name, launches = profile_call(fn)
            busy = sum(by_name.values())
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
            print(json.dumps({
                "shape": name, "call": what, "new_key_set_seal_s": cold,
                "wall_s": wall, "device_busy_us": busy, "busy_share": busy / 1e6 / wall,
                "device_launches": launches,
                "top_kernels_us": [[k[:100], round(v, 1)] for k, v in top]}))
    print(json.dumps({"k10_lane_targets": lane_target_times(dev, rng)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
