#!/usr/bin/env python3
"""The lane-spread kernels K13/K14 (chain_packed.cu) and K16 (kw_wheel.cu) of
micro_aes_tpu_torch, for comparing two checkouts on one NVIDIA GPU.

    python3 tools/spread_ab.py sass [CHECKOUT_ROOT] [--dump FILE]
    python3 tools/spread_ab.py time [CHECKOUT_ROOT]
    python3 tools/spread_ab.py sizes [CHECKOUT_ROOT]
    python3 tools/spread_ab.py ab PARENT_ROOT CHANGE_ROOT

`sass` builds the checkout's kernels and counts, from `cuobjdump -sass` of the
library, the instructions of every loop (a backward branch) of the K13 and
K16 kernels by class: LOP3, other ALU, SHFL, LDS/STS, LDG/STG and branch or
loop overhead.  The round loop is the smallest loop that holds a SHFL, the
step loop the smallest one around it; an instance whose rounds are
unrolled has no round loop, and its step loop holds them all (one per
key size, told apart by the SHFL count).  --dump writes the SASS
of those kernels to FILE.

`time` runs, at chip_smoke.py's shapes with a random key per message, CUDA
events (five means of 10 launches after a warm-up): K13's CBC, CFB and OFB
(AES-256) and CBC-MAC (AES-128) at 4096 messages x 256 blocks, K14's CBC,
CFB and OFB there, K16 wrap and unwrap in both maps at 2048 x 64 semiblocks
(AES-128), and K13 CBC at AES-128/192 and K16 at AES-192/256 at those
shapes, and the ragged entries (K13 CBC/CFB/OFB, K16 wrap/unwrap, where the
checkout has them) on the same inputs as one run of words, the launch the
batch APIs make for a batch of one length and key size; and on the host
clock (five warm calls each) the 2048 x 512 B
(AES-128) and 4096 x 32 B (AES-256) KW wraps, the 4096 x 4 KiB AES-256
CBC batch, the 256-secret ragged KW batch both ways (KEKs of 16/24/32 B in turn, 16-512 B secrets) and
a ragged chain batch of 256 messages (CBC, CFB and OFB, keys of 16/24/32 B
in turn, 0-4 KiB).  It prints one JSON line with the checkout, the card's
nvidia-smi line, the times and a SHA-256 of each output: two checkouts that
agree bit for bit print the same digests.

`sizes` times every key size (CUDA events, min of three means of 10):
K13's CBC, CFB, OFB and CBC-MAC at 4096 x 256 and K16 wrap and unwrap at
2048 x 64, AES-128/192/256, and the ragged entries there as one run, with
digests; it compares variants of one
design, e.g. copies of a checkout with one constant changed, run in turns.

`ab` runs `time` on the parent, the change, the change and the parent, each
in its own process, one after another on the same card.
"""
from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()

# -- sass ---------------------------------------------------------------------

_BRANCH = ("BRA", "BSSY", "BSYNC", "WARPSYNC", "EXIT", "RET", "CALL", "BAR", "BPT", "NOP",
           "YIELD", "JMP", "BREAK", "ISETP", "PLOP3", "VOTE", "VOTEU")


def _klass(op: str) -> str:
    """Class of one SASS mnemonic (without its modifiers)."""
    if op == "LOP3":
        return "lop3"
    if op == "SHFL":
        return "shfl"
    if op in ("LDS", "STS", "LDSM"):
        return "lds_sts"
    if op in ("LDG", "STG", "LD", "ST", "LDGSTS", "LDL", "STL"):
        return "ldg_stg"
    if op in _BRANCH:
        return "branch_loop"
    return "other_alu"


def _code(func: str) -> list[tuple[int, str]]:
    out = []
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][^;]*);", func):
        out.append((int(m.group(1), 16), m.group(2)))
    return out


def _counts(body: list[str]) -> dict:
    c = {"total": len(body), "lop3": 0, "other_alu": 0, "shfl": 0, "lds_sts": 0,
         "ldg_stg": 0, "branch_loop": 0}
    ops: dict[str, int] = {}
    for text in body:
        op = text.split()[0].split(".")[0]
        c[_klass(op)] += 1
        ops[op] = ops.get(op, 0) + 1
    c["by_op"] = dict(sorted(ops.items(), key=lambda kv: -kv[1]))
    return c


def loops(func: str) -> list[dict]:
    """Every loop (a backward branch) of one SASS function: its address span
    and its instructions by class, innermost first."""
    code = _code(func)
    found = []
    for addr, text in code:
        hit = re.match(r"BRA\s.*?0x([0-9a-f]+)", text)
        if not hit or int(hit.group(1), 16) >= addr:
            continue
        lo = int(hit.group(1), 16)
        body = [t for a, t in code if lo <= a <= addr]
        found.append({"span": [lo, addr], **_counts(body)})
    found.sort(key=lambda d: d["total"])
    return found


def kernel_loops(func: str) -> dict:
    """The loops of one K13/K16 function that hold a SHFL.  With the rounds
    rolled, the round loop is the smallest such loop and the step loop the
    smallest one around it; with the rounds unrolled there is one step loop
    per key size, told apart by its SHFL count (24R - 16 to encrypt, 32R - 24
    to decrypt, R rounds)."""
    ls = [d for d in loops(func) if d["shfl"]]
    inner = [d for d in ls if not any(e is not d and d["span"][0] <= e["span"][0]
                                      and e["span"][1] <= d["span"][1] for e in ls)]
    if len(inner) == 1 and len(ls) > 1:
        outer = [d for d in ls if d is not inner[0] and d["span"][0] <= inner[0]["span"][0]
                 and d["span"][1] >= inner[0]["span"][1]]
        return {"round_loop": inner[0], "step_loop": outer[0]}
    out = {}
    for d in inner:
        rounds = next((r for r in (10, 12, 14) if d["shfl"] in (24 * r - 16, 32 * r - 24)), None)
        out[f"step_loop_{rounds}" if rounds else f"loop_{d['span'][0]}"] = d
    return out


def sass(root: Path, dump: Path | None) -> dict:
    sys.path.insert(0, str(root.resolve()))
    from micro_aes_tpu_torch.ops import _build

    lib = _build.build()
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out, kept = {}, []
    for func in re.split(r"\n\s*Function : ", text):
        name = func.split("\n", 1)[0].strip()
        if "chain_packed" in name or "kw_wheel" in name:
            out[name] = kernel_loops(func)
            kept.append(f"Function : {func}")
    if dump:
        dump.parent.mkdir(parents=True, exist_ok=True)
        dump.write_text("\n".join(kept))
    ptxas = [ln.strip() for ln in _build.build_info.log.splitlines()
             if "chain_packed" in ln or "kw_wheel" in ln or "registers" in ln]
    return {"checkout": str(root), "library": lib.name, "kernels": out, "ptxas": ptxas}


# The ragged entries on the uniform shapes as one run of words in batch
# order: the launch the batch APIs make for a batch of one length and key
# size.  {name: thunk}; empty for a checkout without the entries.

def _pad15(k):
    import torch

    return torch.cat([k, k.new_zeros((15 - k.shape[0],) + k.shape[1:])]).contiguous()


def chain_one_run(ck, kp, ivs, blocks) -> dict:
    """K13's chain_packed_ragged (CBC, CFB, OFB) on uint8[B, nb, 16] blocks."""
    if not hasattr(ck, "chain_packed_ragged"):
        return {}
    from micro_aes_tpu_torch.ops.ragged import ragged_layout

    b, nb = blocks.shape[:2]
    lay = ragged_layout([nb] * b, [kp.shape[0] - 1] * b, [16 * nb] * b)
    k15, flat = _pad15(kp), blocks.reshape(-1)
    return {"cbc": lambda: ck.chain_packed_ragged("cbc", k15, lay.desc, ivs, flat),
            "cfb": lambda: ck.chain_packed_ragged("cfb", k15, lay.desc, ivs, flat),
            "ofb": lambda: ck.chain_packed_ragged("ofb", k15, lay.desc, ivs, None, flat.numel())}


def kw_one_run(kk, kp, secrets, wrapped) -> dict:
    """K16's kw_wheel_ragged (wrap, unwrap) on uint8[B, n, 8] secrets."""
    import torch

    if not hasattr(kk, "kw_wheel_ragged"):
        return {}
    from micro_aes_tpu_torch.ops.ragged import ragged_layout

    b, n = secrets.shape[:2]
    lay = ragged_layout([n] * b, [kp.shape[0] - 1] * b, [8 * (n + 1)] * b)
    k15 = _pad15(kp)
    rows = torch.cat([secrets.new_zeros(b, 1, 8), secrets], 1).reshape(-1)  # R at semiblock 1
    wflat = wrapped.reshape(-1).contiguous()
    return {"wrap": lambda: kk.kw_wheel_ragged(k15, lay.desc, rows),
            "unwrap": lambda: kk.kw_wheel_ragged(k15, lay.desc, wflat, True)}


# -- time ---------------------------------------------------------------------

B, NB, KW_B, KW_N, SEED = 4096, 256, 2048, 64, 13


def timed(root: Path) -> dict:
    import time

    import numpy as np
    import torch

    sys.path.insert(0, str(root.resolve()))
    from micro_aes_tpu_torch.core.bitslice import key_planes_packed, wide_perm
    from micro_aes_tpu_torch.modes import bulk
    from micro_aes_tpu_torch.modes import chain_bulk as cb
    from micro_aes_tpu_torch.modes.bulk import stack_round_keys
    from micro_aes_tpu_torch.ops import chain_kernels as ck
    from micro_aes_tpu_torch.ops import kw_kernels as kk
    from micro_aes_tpu_torch.utils.bytesio import u32_tensor

    def cuda_ms(fn, reps=10):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def host_s(fn, reps=5):
        fn()
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return out

    def digest(x):
        if isinstance(x, torch.Tensor):
            x = x.cpu().numpy().tobytes()
        elif isinstance(x, list):
            x = b"".join(b"\0" if v is None else bytes(v) for v in x)
        return hashlib.sha256(x).hexdigest()[:16]

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    def rks(b, klen):
        return stack_round_keys([rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
                                 for _ in range(b)])

    ivs, blocks = u8(B, 16), u8(B, NB, 16)
    nvalid = torch.from_numpy(rng.integers(0, NB + 1, B).astype(np.int32)).to(dev)
    r256, r128 = rks(B, 32), rks(B, 16)
    kp256, kp128 = u32_tensor(key_planes_packed(r256), dev), u32_tensor(key_planes_packed(r128), dev)
    kp256w = u32_tensor(key_planes_packed(r256[wide_perm(B)]), dev)
    kp128, kp192 = (u32_tensor(key_planes_packed(rks(B, k)), dev) for k in (16, 24))
    kw_r = rks(KW_B, 16)
    kw_kp = u32_tensor(key_planes_packed(kw_r), dev)
    kw_kpw = u32_tensor(key_planes_packed(kw_r[wide_perm(KW_B)]), dev)
    kw_kp192, kw_kp256 = (u32_tensor(key_planes_packed(rks(KW_B, k)), dev) for k in (24, 32))
    secrets = u8(KW_B, KW_N, 8)
    wrapped = kk.kw_packed(kw_kp, secrets)
    wrapped192, wrapped256 = kk.kw_packed(kw_kp192, secrets), kk.kw_packed(kw_kp256, secrets)
    kernels = {
        "k13_cbc": lambda: ck.chain_packed_fused("cbc", kp256, ivs, blocks),
        "k13_cfb": lambda: ck.chain_packed_fused("cfb", kp256, ivs, blocks),
        "k13_ofb": lambda: ck.ofb_packed_fused(kp256, ivs, NB),
        "k13_cbcmac": lambda: ck.cbcmac_packed_fused(kp128, ivs, blocks, nvalid),
        "k14_cbc": lambda: ck.chain_packed_fused_wide("cbc", kp256w, ivs, blocks),
        "k14_cfb": lambda: ck.chain_packed_fused_wide("cfb", kp256w, ivs, blocks),
        "k14_ofb": lambda: ck.ofb_packed_fused_wide(kp256w, ivs, NB),
        "k16_wrap": lambda: kk.kw_packed(kw_kp, secrets),
        "k16_unwrap": lambda: kk.kw_packed(kw_kp, wrapped, True),
        "k16_wrap_wide": lambda: kk.kw_packed_fused(kw_kpw, secrets),
        "k16_unwrap_wide": lambda: kk.kw_packed_fused(kw_kpw, wrapped, True),
        # the other key sizes: K13 CBC, K16 wrap and unwrap
        "k13_cbc_aes128": lambda: ck.chain_packed_fused("cbc", kp128, ivs, blocks),
        "k13_cbc_aes192": lambda: ck.chain_packed_fused("cbc", kp192, ivs, blocks),
        "k16_wrap_aes192": lambda: kk.kw_packed(kw_kp192, secrets),
        "k16_unwrap_aes192": lambda: kk.kw_packed(kw_kp192, wrapped192, True),
        "k16_wrap_aes256": lambda: kk.kw_packed(kw_kp256, secrets),
        "k16_unwrap_aes256": lambda: kk.kw_packed(kw_kp256, wrapped256, True),
    }
    # the ragged entries at the shapes above, one run each (what the batches launch)
    for kind, fn in chain_one_run(ck, kp256, ivs, blocks).items():
        kernels[f"k13_ragged_{kind}"] = fn
    for kind, fn in kw_one_run(kk, kw_kp, secrets, wrapped).items():
        kernels[f"k16_ragged_{kind}"] = fn
    if "cbc" in (k128 := chain_one_run(ck, kp128, ivs, blocks)):
        kernels["k13_ragged_cbc_aes128"] = k128["cbc"]
    ms, sha = {}, {}
    for name, fn in kernels.items():
        sha[name] = digest(fn())
        ms[name] = [round(cuda_ms(fn), 4) for _ in range(5)]

    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    nrag = 256
    keks = [rand((16, 24, 32)[i % 3]) for i in range(nrag)]
    rsecrets = [rand(8 * int(x)) for x in rng.integers(2, 65, nrag)]
    rwrapped = bulk.key_wrap_batch(keks, rsecrets, device=dev)
    ckeys = [rand((16, 24, 32)[i % 3]) for i in range(nrag)]
    civs = [rand(16) for _ in range(nrag)]
    cpts = [rand(int(x)) for x in rng.integers(0, 4097, nrag)]
    big_keks = [rand(16) for _ in range(KW_B)]
    big_secrets = [rand(8 * KW_N) for _ in range(KW_B)]
    dk_keks, dk_secrets = [rand(32) for _ in range(B)], [rand(32) for _ in range(B)]
    ckeys256 = [rand(32) for _ in range(B)]
    civs256 = [rand(16) for _ in range(B)]
    cpts256 = [rand(16 * NB) for _ in range(B)]
    requests = {
        "kw_2048x512B_wrap": lambda: bulk.key_wrap_batch(big_keks, big_secrets, device=dev),
        "kw_4096x32B_wrap": lambda: bulk.key_wrap_batch(dk_keks, dk_secrets, device=dev),
        "chain_4096x4KiB_cbc": lambda: cb.cbc_encrypt_batch(ckeys256, civs256, cpts256,
                                                            device=dev),
        "kw_ragged_wrap": lambda: bulk.key_wrap_batch(keks, rsecrets, device=dev),
        "kw_ragged_unwrap": lambda: bulk.key_unwrap_batch(keks, rwrapped, device=dev),
        "chain_ragged_cbc": lambda: cb.cbc_encrypt_batch(ckeys, civs, cpts, device=dev),
        "chain_ragged_cfb": lambda: cb.cfb_encrypt_batch(ckeys, civs, cpts, device=dev),
        "chain_ragged_ofb": lambda: cb.ofb_xcrypt_batch(ckeys, civs, cpts, device=dev),
    }
    secs = {}
    for name, fn in requests.items():
        sha[name] = digest(fn())
        secs[name] = [round(s, 5) for s in host_s(fn)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    return {"checkout": str(root), "nvidia_smi": smi, "kernel_ms": ms, "host_s": secs,
            "sha256": sha}


def sizes(root: Path) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, str(root.resolve()))
    from micro_aes_tpu_torch.core.bitslice import key_planes_packed
    from micro_aes_tpu_torch.modes.bulk import stack_round_keys
    from micro_aes_tpu_torch.ops import chain_kernels as ck
    from micro_aes_tpu_torch.ops import kw_kernels as kk
    from micro_aes_tpu_torch.utils.bytesio import u32_tensor

    def cuda_ms(fn, reps=10):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(5)

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    def planes(b, klen):
        return u32_tensor(key_planes_packed(stack_round_keys(
            [rng.integers(0, 256, klen, dtype=np.uint8).tobytes() for _ in range(b)])), dev)

    ivs, blocks = u8(B, 16), u8(B, NB, 16)
    nvalid = torch.from_numpy(rng.integers(0, NB + 1, B).astype(np.int32)).to(dev)
    cases = {}
    for klen in (16, 24, 32):
        kp = planes(B, klen)
        cases.update({
            f"cbc{8 * klen}": lambda kp=kp: ck.chain_packed_fused("cbc", kp, ivs, blocks),
            f"cfb{8 * klen}": lambda kp=kp: ck.chain_packed_fused("cfb", kp, ivs, blocks),
            f"ofb{8 * klen}": lambda kp=kp: ck.ofb_packed_fused(kp, ivs, NB),
            f"mac{8 * klen}": lambda kp=kp: ck.cbcmac_packed_fused(kp, ivs, blocks, nvalid)})
        for kind, fn in chain_one_run(ck, kp, ivs, blocks).items():
            cases[f"ragged_{kind}{8 * klen}"] = fn
    secrets = u8(KW_B, KW_N, 8)
    for klen in (16, 24, 32):
        kp = planes(KW_B, klen)
        wrapped = kk.kw_packed(kp, secrets)
        cases.update({
            f"wrap{8 * klen}": lambda kp=kp: kk.kw_packed(kp, secrets),
            f"unwrap{8 * klen}": lambda kp=kp, w=wrapped: kk.kw_packed(kp, w, True)})
        for kind, fn in kw_one_run(kk, kp, secrets, wrapped).items():
            cases[f"ragged_{kind}{8 * klen}"] = fn
    ms, sha = {}, {}
    for name, fn in cases.items():
        sha[name] = hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest()[:12]
        ms[name] = round(min(cuda_ms(fn) for _ in range(3)), 4)
    return {"root": str(root), "ms": ms, "sha": sha}


def main() -> int:
    args = sys.argv[1:]
    if not args or args[0] not in ("sass", "time", "sizes", "ab"):
        print(__doc__, file=sys.stderr)
        return 2
    if args[0] == "ab":
        rc = 0
        for root in (args[1], args[2], args[2], args[1]):
            rc |= subprocess.run([sys.executable, str(HERE), "time", root]).returncode
        return rc
    dump = None
    if "--dump" in args:
        i = args.index("--dump")
        dump = Path(args[i + 1])
        del args[i:i + 2]
    root = Path(args[1]) if len(args) > 1 else HERE.parent.parent
    if args[0] == "sass":
        print(json.dumps(sass(root, dump)), flush=True)
    else:
        import torch

        if not torch.cuda.is_available():
            print("spread_ab: needs an NVIDIA GPU", file=sys.stderr)
            return 1
        print(json.dumps((timed if args[0] == "time" else sizes)(root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
