#!/usr/bin/env python3
"""K9 (multikey.cu) and the one-pass AEAD chains (K11/K12, with K15 and
K13's MAC, aead_chain.cu and chain_packed.cu) of micro_aes_tpu_torch, for
comparing two checkouts on one NVIDIA GPU.

    python3 tools/mk_ab.py sass [CHECKOUT_ROOT] [--dump FILE]
    python3 tools/mk_ab.py time [CHECKOUT_ROOT]
    python3 tools/mk_ab.py k9 [CHECKOUT_ROOT]
    python3 tools/mk_ab.py ab PARENT_ROOT CHANGE_ROOT

`sass` builds the checkout's kernels and counts, from `cuobjdump -sass` of the
library, the instructions of K9's kernels (`*multikey*`), of K3
(`ctr_fused_kernel`, the single-key yardstick), of the AEAD kernels
(`aead_chain_kernel`, `ctr_packed_kernel`) and of K13's MAC
(`chain_packed_kernel<3>`): the whole function and every loop (a backward
branch), innermost first, by class (tools/spread_ab.py's classes: LOP3,
other ALU, SHFL, LDS/STS, LDG/STG, branch or loop overhead) and the one-byte
global accesses (`LDG.*.U8`, `STG.*.U8`); and, for the AddRoundKey of K9 in
isolation, four forms of a 16-byte round key added to 128 plane words,
compiled alone (nvcc -cubin, sm_90a) and counted in their round loop: the
shift-mask-negate form, a one-bit sign extension, a predicated NOT and
planes read from shared memory.  --dump writes the SASS of those kernels
to FILE.

`time` runs, with a random key per message (CUDA events, five means of 10
after a warm-up): K9 through its JAX-contract wrapper `ctrw_fused_multikey`
at 1024 messages x 16 KB (AES-128, the window of 1,025 blocks), the kernel
alone on round keys prepared in advance, the plane -> byte conversion alone
where the checkout has it, K3 on as many stream rows (AES-128) and the
ragged entry (where the checkout has it) on a ragged 256-message mix of key
sizes, its descriptors already on the card (the kernel, not the host's
checks and copy); K11 (CCM and EAX, seal and open) at 2048 x 256 and K12 (seal, open)
at 4096 x 256 as the calls the batches make (AES-128), K13's CBC-MAC and K15
at 4096 x 256; and on the host clock (five warm calls each) the 4096 x 4
KiB AES-256 CBC-CTS and CFB decrypt batches, the ragged 256-message ECB
encrypt and decrypt, CTR, CBC-CTS decrypt and CFB decrypt batches (keys of
16/24/32 B in turn, 0-4 KiB), the ragged TLS-shaped GCM
batch, the CCM/EAX batches at 2048 x 4 KiB and SIV at 4096 x 4 KiB, and a
ragged 256-message AEAD batch (CCM, EAX, SIV, both ways).  It prints one
JSON line with the checkout, the card's nvidia-smi line, the times and a
SHA-256 of each output: two checkouts that agree bit for bit print the same
digests.

`k9` times K9 alone (CUDA events, min of three means of 10, with digests)
on the shapes that tell its designs apart: the uniform cipher-and-xor on
round keys at 1024 x 16 KB (AES-128, 40-row windows), K3 on as many rows,
and the ragged entry (descriptors on the card) on 1024 messages of 1,025
blocks (AES-128), 4096 of 256 blocks (AES-256, decrypt: the CBC batches),
256 messages of 0-256 blocks and 256 TLS-record-shaped messages of 1-129
blocks (keys of 16/24/32 B in turn); it compares variants of one design, e.g. copies of a
checkout with one constant changed, run in turns.

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
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve()
sys.path.insert(0, str(HERE.parent))

from spread_ab import _code, _counts, loops  # noqa: E402

# -- sass ---------------------------------------------------------------------

_KERNELS = ("multikey", "ctr_fused_kernel", "aead_chain_kernel", "ctr_packed_kernel",
            "chain_packed_kernelILi3E")


def _u8_access(body: list[str]) -> dict:
    return {"ldg_u8": sum(1 for t in body if re.match(r"LDG\S*\.U8", t)),
            "stg_u8": sum(1 for t in body if re.match(r"STG\S*\.U8", t)),
            "lds_u8": sum(1 for t in body if re.match(r"LDS\S*\.U8", t)),
            "sts_u8": sum(1 for t in body if re.match(r"STS\S*\.U8", t))}


def function_counts(func: str) -> dict:
    body = [t for _, t in _code(func)]
    whole = {**_counts(body), **_u8_access(body)}
    ls = []
    for d in loops(func):
        lo, hi = d["span"]
        inner = [t for a, t in _code(func) if lo <= a <= hi]
        ls.append({**d, **_u8_access(inner)})
    return {"function": whole, "loops": ls}


# AddRoundKey of one 16-byte round key onto 128 plane words, in isolation
ARK_PROBE = r"""
#include <cstdint>
template <int FORM>
__global__ void ark_probe(const uint4* __restrict__ rk, uint32_t* __restrict__ io, int rounds) {
  __shared__ uint32_t kps[15 * 128];
  for (int i = threadIdx.x; i < 15 * 128; i += blockDim.x) kps[i] = io[i];
  __syncthreads();
  const size_t n = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  uint32_t s[8][16];
#pragma unroll
  for (int b = 0; b < 8; ++b)
#pragma unroll
    for (int p = 0; p < 16; ++p) s[b][p] = io[(b * 16 + p) * n + t];
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    if (FORM == 3) {
#pragma unroll
      for (int b = 0; b < 8; ++b)
#pragma unroll
        for (int p = 0; p < 16; ++p) s[b][p] ^= kps[r * 128 + b * 16 + p];
      continue;
    }
    const uint4 v = __ldg(rk + t * 15 + r);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int b = 0; b < 8; ++b)
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        const int bit = 8 * (p & 3) + b;
        if (FORM == 0) {
          s[b][p] ^= 0u - ((w[p >> 2] >> bit) & 1u);
        } else if (FORM == 1) {
          s[b][p] ^= static_cast<uint32_t>(static_cast<int32_t>(w[p >> 2] << (31 - bit)) >> 31);
        } else {
          asm("{ .reg .pred q; setp.ne.u32 q, %1, 0; @q not.b32 %0, %0; }"
              : "+r"(s[b][p]) : "r"(w[p >> 2] & (1u << bit)));
        }
      }
  }
#pragma unroll
  for (int b = 0; b < 8; ++b)
#pragma unroll
    for (int p = 0; p < 16; ++p) io[(b * 16 + p) * n + t] = s[b][p];
}
template __global__ void ark_probe<0>(const uint4*, uint32_t*, int);
template __global__ void ark_probe<1>(const uint4*, uint32_t*, int);
template __global__ void ark_probe<2>(const uint4*, uint32_t*, int);
template __global__ void ark_probe<3>(const uint4*, uint32_t*, int);
"""
ARK_FORMS = ("shift_mask_negate", "sign_extend", "predicated_not", "smem_planes")


def ark_forms(nvcc: str, cuobjdump: str) -> dict:
    """The round loop of each AddRoundKey form, compiled alone."""
    with tempfile.TemporaryDirectory() as tmp:
        src, cubin = Path(tmp, "ark.cu"), Path(tmp, "ark.cubin")
        src.write_text(ARK_PROBE)
        built = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                                "-cubin", "-o", str(cubin), str(src)], capture_output=True,
                               text=True)
        if built.returncode:
            return {"error": built.stdout + built.stderr}
        text = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True, text=True,
                              check=True).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", text):
        m = re.search(r"ark_probeILi(\d)E", func.split("\n", 1)[0])
        if m:
            ls = loops(func)
            out[ARK_FORMS[int(m.group(1))]] = ls[-1] if ls else None  # the round loop
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
        if any(k in name for k in _KERNELS):
            out[name] = function_counts(func)
            kept.append(f"Function : {func}")
    if dump:
        dump.parent.mkdir(parents=True, exist_ok=True)
        dump.write_text("\n".join(kept))
    ptxas, cur = [], None
    for ln in _build.build_info.log.splitlines():
        if "Function properties for" in ln:
            cur = ln.split("for", 1)[1].strip()
        elif cur and "Used" in ln and any(k in cur for k in _KERNELS):
            ptxas.append(f"{cur}: {ln.strip()}")
            cur = None
        elif "spill" in ln and cur and any(k in cur for k in _KERNELS):
            ptxas.append(f"{cur}: {ln.strip()}")
    return {"checkout": str(root), "library": lib.name, "kernels": out, "ptxas": ptxas,
            "ark_forms": ark_forms(_build._nvcc(), cuobjdump)}


# -- time ---------------------------------------------------------------------

MK_B, MK_BYTES, AEAD_B, SIV_B, NB, SEED = 1024, 16 << 10, 2048, 4096, 256, 17


def timed(root: Path) -> dict:
    import time

    import numpy as np
    import torch

    sys.path.insert(0, str(root.resolve()))
    from micro_aes_tpu_torch.core.bitslice import key_planes_batch, key_planes_packed
    from micro_aes_tpu_torch.modes import bulk
    from micro_aes_tpu_torch.modes import chain_bulk as cb
    from micro_aes_tpu_torch.modes.bulk import stack_round_keys
    from micro_aes_tpu_torch.modes.common import PAD_PKCS7
    from micro_aes_tpu_torch.ops import _build
    from micro_aes_tpu_torch.ops import aead_kernels as ak
    from micro_aes_tpu_torch.ops import chain_kernels as ck
    from micro_aes_tpu_torch.ops import multikey as mk
    from micro_aes_tpu_torch.ops.counter import j0_planes, lohi_words
    from micro_aes_tpu_torch.ops.seal_kernels import ctr_fused
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
        elif isinstance(x, tuple):
            return digest(b"".join(bytes.fromhex(digest(v)) for v in x))
        elif isinstance(x, list):
            x = b"".join(b"\0" if v is None else
                         (b"".join(v) if isinstance(v, tuple) else bytes(v)) for v in x)
        return hashlib.sha256(x).hexdigest()[:16]

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    def rks(b, klen):
        return stack_round_keys([rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
                                 for _ in range(b)])

    kernels = {}
    # K9 at the ragged GCM's keystream of 1024 x 16 KB: E(J0) and 1,024 blocks
    wm = mk.mk_window_words(MK_BYTES // 16 + 1)
    rows = MK_B * wm
    r128 = rks(MK_B, 16)
    rk_dev = torch.from_numpy(r128).to(dev)
    kp_stack = key_planes_batch(rk_dev).reshape(-1, 1)
    ctr = torch.from_numpy(rng.integers(-2**31, 2**31, (rows, 128), dtype=np.int64)
                           .astype(np.int32)).to(dev)
    pt = torch.from_numpy(rng.integers(-2**31, 2**31, (rows, 128), dtype=np.int64)
                          .astype(np.int32)).to(dev)
    kernels["k9_wrapper"] = lambda: mk.ctrw_fused_multikey(kp_stack, ctr, pt, MK_B)
    kernels["k9_wrapper_dec"] = lambda: mk.ctrw_fused_multikey(kp_stack, ctr, pt, MK_B, True)
    if hasattr(mk, "ctrw_multikey_rks"):  # the kernel on round-key bytes
        kernels["k9_kernel"] = lambda: mk.ctrw_multikey_rks(rk_dev, ctr, pt, MK_B)
    else:
        lib = _build.load()
        stream = torch.cuda.current_stream(dev).cuda_stream

        def k9_raw():
            out = torch.empty_like(pt)
            lib.micro_aes_ctrw_multikey(rk_dev.data_ptr(), ctr.data_ptr(), pt.data_ptr(),
                                        out.data_ptr(), 10, wm, rows, 0, stream)
            return out

        kernels["k9_kernel"] = k9_raw
    if hasattr(mk, "_round_key_bytes"):
        kernels["k9_plane_to_bytes"] = lambda: mk._round_key_bytes(kp_stack, MK_B, 10)
    j0 = u8(16)
    kp3 = key_planes_batch(rk_dev[:1]).reshape(-1, 1)
    j0c, lohi = j0_planes(j0), lohi_words(j0, rows, -1)
    kernels["k3_aes128_same_rows"] = lambda: ctr_fused(kp3, j0c, lohi, pt)
    # K9's ragged entry on a 256-message mix: keys of 16/24/32 B in turn, 0..4 KiB
    rag_keys = [rng.integers(0, 256, (16, 24, 32)[i % 3], dtype=np.uint8).tobytes()
                for i in range(256)]
    rag_nb = [int(x) for x in rng.integers(0, 257, 256)]
    blk = u8(sum(rag_nb), 16)  # drawn in every checkout, so that later inputs agree
    if hasattr(mk, "cipher_blocks_ragged"):
        lay = mk.multikey_layout(rag_keys, rag_nb)
        rk15 = mk.layout_round_keys(rag_keys, dev)
        desc = torch.from_numpy(lay.desc).to(dev)  # on the card: the kernel, not the host checks
        kernels["k9_ragged"] = lambda: mk.cipher_blocks_ragged(rk15, desc, blk)
        kernels["k9_ragged_dec"] = lambda: mk.cipher_blocks_ragged(rk15, desc, blk, True)
    # K11 at 2048 x 256 and K12 at 4096 x 256, AES-128, as the batches call them
    for b, names in ((AEAD_B, ("ccm", "eax")), (SIV_B, ("siv",))):
        kpw = u32_tensor(key_planes_packed(rks(b, 16)), dev)
        kpc = u32_tensor(key_planes_packed(rks(b, 16)), dev)
        c0, init, tail, lastadd, prevadd = (u8(b, 16) for _ in range(5))
        blocks = u8(b, NB, 16)
        nv = rng.integers(0, NB + 1, b).astype(np.int32)
        nv[:2] = (1, NB)
        if "siv" in names:
            nv = np.maximum(nv, 1)
        nvalid = torch.from_numpy(nv).to(dev)
        for kind in names:
            if kind == "siv":
                kernels["k12_seal"] = lambda a=(kpw, kpc, init, blocks, nvalid, tail, lastadd,
                                                prevadd): ak.siv_seal_chain_fused(*a)
                kernels["k12_open"] = lambda a=(kpw, kpc, c0, init, blocks, nvalid, tail,
                                                lastadd, prevadd): ak.siv_open_chain_fused(*a)
                kernels["k13_cbcmac"] = lambda a=(kpw, init, blocks, nvalid): \
                    ck.cbcmac_packed_fused(*a)
                kernels["k15"] = lambda a=(kpw, c0, blocks): ak.ctr_packed_fused(*a)
                continue
            for decrypt in (False, True):
                kernels[f"k11_{kind}{'_open' if decrypt else ''}"] = \
                    lambda a=(kind, kpw, c0, init, blocks, nvalid, tail, lastadd, decrypt): \
                    ak.aead_chain_fused(*a)
    ms, sha = {}, {}
    for name, fn in kernels.items():
        sha[name] = digest(fn())
        ms[name] = [round(cuda_ms(fn), 4) for _ in range(5)]

    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    nrag = 256
    ckeys = [rand((16, 24, 32)[i % 3]) for i in range(nrag)]
    civs = [rand(16) for _ in range(nrag)]
    clens = [int(x) | 1 for x in rng.integers(0, 4096, nrag)]
    clens[0] = 0
    cpts = [rand(n) for n in clens]
    cts_idx = [i for i, n in enumerate(clens) if n >= 16]
    tk, tiv, tpt = ([v[i] for i in cts_idx] for v in (ckeys, civs, cpts))
    tct = cb.cbc_encrypt_batch(tk, tiv, tpt, device=dev)
    cfb_ct = cb.cfb_encrypt_batch(ckeys, civs, cpts, device=dev)
    ecb_ct = cb.ecb_encrypt_batch(ckeys, cpts, PAD_PKCS7, device=dev)
    nonces = [iv[:12] for iv in civs]
    glens = [int(x) | 1 for x in rng.integers(0, 2048, nrag)]
    gkeys, gnonces = [rand((16, 24, 32)[i % 3]) for i in range(nrag)], [rand(12)] * nrag
    gaads, gpts = [rand(13) for _ in range(nrag)], [rand(n) for n in glens]
    size = 16 * NB
    blob = rand(SIV_B * size)
    apts = [blob[i * size:(i + 1) * size] for i in range(SIV_B)]
    akeys, anonces, aaads = [rand(16) for _ in range(AEAD_B)], [rand(12) for _ in range(AEAD_B)], \
        [b"hdr"] * AEAD_B
    skeys = [rand(32) for _ in range(SIV_B)]
    alens = [int(x) for x in rng.integers(0, 4097, nrag)]
    alens[:4] = (0, 1, 15, 16)
    rkeys = [rand((16, 24, 32)[i % 3]) for i in range(nrag)]
    rskeys = [k + rand(len(k)) for k in rkeys]
    rnonces = [rand(11 + i % 3) for i in range(nrag)]
    raads = [rand(int(x)) for x in rng.integers(0, 41, nrag)]
    rpts = [rand(n) for n in alens]
    rccm = bulk.ccm_encrypt_batch(rkeys, rnonces, raads, rpts, device=dev)
    reax = bulk.eax_encrypt_batch(rkeys, rnonces, raads, rpts, device=dev)
    rsiv = bulk.siv_encrypt_batch(rskeys, raads, rpts, device=dev)
    dkeys, divs = [rand(32) for _ in range(SIV_B)], [rand(16) for _ in range(SIV_B)]
    dcbc = cb.cbc_encrypt_batch(dkeys, divs, apts, device=dev)
    dcfb = cb.cfb_encrypt_batch(dkeys, divs, apts, device=dev)
    requests = {
        "cbc_dec_4096x4KiB": lambda: cb.cbc_decrypt_batch(dkeys, divs, dcbc, device=dev),
        "cfb_dec_4096x4KiB": lambda: cb.cfb_decrypt_batch(dkeys, divs, dcfb, device=dev),
        "ragged_ecb_enc": lambda: cb.ecb_encrypt_batch(ckeys, cpts, PAD_PKCS7, device=dev),
        "ragged_ecb_dec": lambda: cb.ecb_decrypt_batch(ckeys, ecb_ct, device=dev),
        "ragged_ctr": lambda: cb.ctr_xcrypt_batch(ckeys, nonces, cpts, device=dev),
        "ragged_cbc_cts_dec": lambda: cb.cbc_decrypt_batch(tk, tiv, tct, device=dev),
        "ragged_cfb_dec": lambda: cb.cfb_decrypt_batch(ckeys, civs, cfb_ct, device=dev),
        "ragged_gcm_seal": lambda: bulk.gcm_encrypt_batch(gkeys, gnonces, gaads, gpts,
                                                          device=dev),
        "ccm_2048x4KiB_seal": lambda: bulk.ccm_encrypt_batch(
            akeys, [n[:11] for n in anonces], aaads, apts[:AEAD_B], device=dev),
        "eax_2048x4KiB_seal": lambda: bulk.eax_encrypt_batch(akeys, anonces, aaads,
                                                             apts[:AEAD_B], device=dev),
        "siv_4096x4KiB_seal": lambda: bulk.siv_encrypt_batch(skeys, [b"hdr"] * SIV_B, apts,
                                                             device=dev),
        "ragged_ccm_seal": lambda: bulk.ccm_encrypt_batch(rkeys, rnonces, raads, rpts,
                                                          device=dev),
        "ragged_ccm_open": lambda: bulk.ccm_decrypt_batch(rkeys, rnonces, raads, rccm,
                                                          device=dev),
        "ragged_eax_seal": lambda: bulk.eax_encrypt_batch(rkeys, rnonces, raads, rpts,
                                                          device=dev),
        "ragged_eax_open": lambda: bulk.eax_decrypt_batch(rkeys, rnonces, raads, reax,
                                                          device=dev),
        "ragged_siv_seal": lambda: bulk.siv_encrypt_batch(rskeys, raads, rpts, device=dev),
        "ragged_siv_open": lambda: bulk.siv_decrypt_batch(
            rskeys, [s[0] for s in rsiv], raads, [s[1] for s in rsiv], device=dev),
    }
    secs = {}
    for name, fn in requests.items():
        sha[name] = digest(fn())
        secs[name] = [round(s, 5) for s in host_s(fn)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    return {"checkout": str(root), "nvidia_smi": smi, "kernel_ms": ms, "host_s": secs,
            "sha256": sha}


def k9(root: Path) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, str(root.resolve()))
    from micro_aes_tpu_torch.core.bitslice import key_planes_batch
    from micro_aes_tpu_torch.modes.bulk import stack_round_keys
    from micro_aes_tpu_torch.ops import multikey as mk
    from micro_aes_tpu_torch.ops.counter import j0_planes, lohi_words
    from micro_aes_tpu_torch.ops.seal_kernels import ctr_fused

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
    rng = np.random.default_rng(SEED + 1)

    def keys(n, klens):
        return [rng.integers(0, 256, klens[i % len(klens)], dtype=np.uint8).tobytes()
                for i in range(n)]

    cases = {}
    wm = mk.mk_window_words(MK_BYTES // 16 + 1)
    rows = MK_B * wm
    rk = torch.from_numpy(stack_round_keys(keys(MK_B, (16,)))).to(dev)
    ctr, pt = (torch.from_numpy(rng.integers(-2**31, 2**31, (rows, 128), dtype=np.int64)
                                .astype(np.int32)).to(dev) for _ in range(2))
    if hasattr(mk, "ctrw_multikey_rks"):
        cases["uniform_xor_1024x16KB_aes128"] = lambda: mk.ctrw_multikey_rks(rk, ctr, pt, MK_B)
    j0 = torch.from_numpy(rng.integers(0, 256, 16, dtype=np.uint8)).to(dev)
    kp3 = key_planes_batch(rk[:1]).reshape(-1, 1)
    j0c, lohi = j0_planes(j0), lohi_words(j0, rows, -1)
    cases["k3_aes128_same_rows"] = lambda: ctr_fused(kp3, j0c, lohi, pt)
    if hasattr(mk, "cipher_blocks_ragged"):
        tls = [int(x) for x in rng.integers(0, 2049, 256)]
        for name, ks, nb, dec in (
                ("ragged_1024x1025_aes128", keys(1024, (16,)), [1025] * 1024, False),
                ("ragged_4096x256_aes256_dec", keys(4096, (32,)), [256] * 4096, True),
                ("ragged_mix256", keys(256, (16, 24, 32)),
                 [int(x) for x in rng.integers(0, 257, 256)], False),
                ("ragged_tls256", keys(256, (16, 24, 32)), [1 + -(-n // 16) for n in tls],
                 False)):
            lay = mk.multikey_layout(ks, nb)
            rks = mk.layout_round_keys(ks, dev)
            desc = torch.from_numpy(lay.desc).to(dev)
            blk = torch.from_numpy(rng.integers(0, 256, (lay.nblocks, 16), dtype=np.uint8)).to(dev)
            cases[name] = lambda rks=rks, desc=desc, blk=blk, dec=dec: mk.cipher_blocks_ragged(
                rks, desc, blk, dec)
    ms, sha = {}, {}
    for name, fn in cases.items():
        sha[name] = hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest()[:12]
        ms[name] = round(min(cuda_ms(fn) for _ in range(3)), 4)
    return {"root": str(root), "ms": ms, "sha": sha}


def main() -> int:
    args = sys.argv[1:]
    if not args or args[0] not in ("sass", "time", "k9", "ab"):
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
            print("mk_ab: needs an NVIDIA GPU", file=sys.stderr)
            return 1
        print(json.dumps((timed if args[0] == "time" else k9)(root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
