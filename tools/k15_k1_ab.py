#!/usr/bin/env python3
"""K15 (aead_chain.cu, the lane-packed CTR keystream of the one-pass AEAD
batches) and K1 (seal_fused.cu, the fused GCM body) of micro_aes_tpu_torch,
for comparing two checkouts on one NVIDIA GPU.

    python3 tools/k15_k1_ab.py sass [CHECKOUT_ROOT] [--dump FILE]
    python3 tools/k15_k1_ab.py gate [CHECKOUT_ROOT]
    python3 tools/k15_k1_ab.py time [CHECKOUT_ROOT]
    python3 tools/k15_k1_ab.py cols [CHECKOUT_ROOT]
    python3 tools/k15_k1_ab.py ab PARENT_ROOT CHANGE_ROOT

`sass` builds the checkout's kernels and counts, from `cuobjdump -sass` of the
library, the instructions of K15 (`ctr_packed_kernel*`), K1
(`seal_fused_kernel*`), K10's cipher half (`chain_cipher_kernel`) and K3
(`ctr_fused_kernel`): the whole function and every loop (a backward
branch), innermost first, by class (tools/spread_ab.py's classes) and every
memory instruction by width and kind (LDS/STS, LDG/STG, LDL/STL spills,
LDSM), with nvcc's `-Xptxas -v` lines for them.  --dump writes their SASS
to FILE.

`gate` builds a micro-benchmark of level 1 of K1 alone (the masked level-1
GHASH of every 32-block row) from the checkout's csrc/aes_bitslice.cuh: over
W = 32,800 rows (16 MiB) with random planes, masks and W1p, blocks of 256
rows as K1 has them, it runs (a) `level1_row` (the fold K4 and K1 first
ran, kept in this tool since K4 left it), (b) `stage_level1_row` and
`level1_mma_warp` (the binary tensor-core product), (c) the row loads
alone and (d) (b) with each parity stored straight from its accumulator
(the first form), checks (a), (b) and (d) bit for bit against each other
and (a) and (b) against the plain version (`ops/seal_kernels.level1_plain`),
and times each (CUDA events, three means of 10).

`time` runs, with random keys and data (CUDA events, three means of 10
after a warm-up): K15 at 4096 x 256 and 2048 x 256 blocks (AES-128), plain
and with CCM's whitener; K15's calls in the ragged 256-message AEAD batch
(CCM, EAX and SIV, both ways; keys of 16/24/32 B in turn, 0-4 KiB), each
call replayed alone and summed; K11 (CCM, EAX, both ways) at 2048 x 256 and
K12 (seal, open) at 4096 x 256 as the batches call them; K1 (seal and open)
and K3 at 16 MiB, AES-256 and AES-128; K10's cipher half
(`chain_cipher_kernel`) on K15's 4096 x 256 inputs, from the profiler's
device time (its fold kernel gets zero tables); and on the host clock (five
warm calls) the CCM and EAX batches at 2048 x 4 KiB, SIV at 4096 x 4 KiB,
the ragged 256 AEAD batch both ways and `gcm_seal`/`gcm_open` at 16 MiB
(AES-256, warm key).  It prints one JSON line with the checkout, the card's
nvidia-smi line, the times and a SHA-256 of each output: two checkouts
that agree bit for bit print the same digests.

`cols` times K15 (device time from the profiler) with each of its thread
layouts forced (4, 2 or 1 state columns a thread, and 0, the entry's own
pick) at the shapes of `time`, at 1024, 512, 256 and 96 messages x 256
blocks, at 4096 x 16 and 4096 x 1, and on the ragged mix's calls, with
digests, where the checkout's C entry takes the layout.

`ab` runs `time` on the parent, the change, the change and the parent, each
in its own process, one after another on the same card.
"""
from __future__ import annotations

import ctypes
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

_KERNELS = ("ctr_packed_kernel", "seal_fused_kernel", "chain_cipher_kernel", "ctr_fused_kernel")
_MEM = ("LDS", "STS", "LDG", "STG", "LDL", "STL", "LDSM", "LD", "ST", "ATOMS", "RED")


def _mem_widths(body: list[str]) -> dict:
    """Memory instructions by kind and width (32 when no width modifier)."""
    out: dict[str, int] = {}
    for text in body:
        parts = text.split()[0].split(".")
        if parts[0] not in _MEM:
            continue
        width = next((p for p in parts[1:] if p in ("U8", "S8", "U16", "S16", "64", "128")), "32")
        key = f"{parts[0]}.{width}"
        out[key] = out.get(key, 0) + 1
    return dict(sorted(out.items()))


def function_counts(func: str) -> dict:
    code = _code(func)
    body = [t for _, t in code]
    ls = []
    for d in loops(func):
        lo, hi = d["span"]
        ls.append({**d, "mem": _mem_widths([t for a, t in code if lo <= a <= hi])})
    return {"function": {**_counts(body), "mem": _mem_widths(body)}, "loops": ls}


def sass(root: Path, dump: Path | None) -> dict:
    sys.path.insert(0, str(root.resolve()))
    from micro_aes_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:  # a fresh build, for nvcc's -Xptxas -v lines
        _build.BUILD_DIR = Path(tmp)
        lib = Path(shutil.copy(_build.build(), Path(tempfile.gettempdir(), "k15_k1_sass.so")))
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
        elif cur and any(k in cur for k in _KERNELS) and ("Used" in ln or "spill" in ln):
            ptxas.append(f"{cur}: {ln.strip()}")
    return {"checkout": str(root), "library": lib.name, "kernels": out, "ptxas": ptxas}


# -- gate ---------------------------------------------------------------------

GATE_SRC = r"""
#include <cuda_runtime.h>
#include "aes_bitslice.cuh"

namespace {
constexpr int kRows = 256;

// level 1 as K4 and K1 first ran it (formerly aes_bitslice.cuh's): the
// planes masked in place by ghm, then s1[o, row] = parity(XOR_q (W1p[o][q] &
// plane q)), one 3-input logic operation per (o, q), 16,384 a row
__device__ __forceinline__ void level1_row(uint32_t (&s)[8][16], uint32_t ghm,
                                           const uint32_t* w1s, int8_t* __restrict__ s1,
                                           int row, int w, bool live) {
#pragma unroll
  for (int b = 0; b < 8; ++b)
#pragma unroll
    for (int p = 0; p < 16; ++p) s[b][p] &= ghm;

#pragma unroll 1
  for (int o = 0; o < 128; ++o) {
    const uint4* wr = reinterpret_cast<const uint4*>(w1s + o * 128);
    uint32_t acc = 0u;
#pragma unroll
    for (int q4 = 0; q4 < 32; ++q4) {
      const uint4 v = wr[q4];
      const int q = 4 * q4;
      acc ^= (v.x & s[q / 16][q % 16]) ^ (v.y & s[(q + 1) / 16][(q + 1) % 16])
           ^ (v.z & s[(q + 2) / 16][(q + 2) % 16]) ^ (v.w & s[(q + 3) / 16][(q + 3) % 16]);
    }
    if (live) s1[static_cast<size_t>(o) * w + row] = static_cast<int8_t>(__popc(acc) & 1);
  }
}

// The first form of level1_mma_warp, for MODE 3:
// the same products, each parity stored straight from its accumulator.
__device__ __forceinline__ void level1_mma_direct(const uint32_t* w1s, const uint32_t* rows,
                                                  int8_t* __restrict__ s1, int row0, int w) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int m = lane >> 3, r = lane & 7;
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    uint32_t acc[8][2][4];
#pragma unroll
    for (int mt = 0; mt < 8; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0u;
    const uint32_t* pb = rows + (16 * pass + 8 * (m >> 1) + r) * uaes::kL1Stride + 4 * (m & 1);
    const uint32_t* pa = w1s + (8 * (m & 1) + r) * uaes::kL1Stride + 4 * (m >> 1);
#pragma unroll 2
    for (int kc = 0; kc < 16; ++kc) {
      uint32_t b[4];
      uaes::ldmatrix_x4(b, pb + 8 * kc);
#pragma unroll
      for (int mt = 0; mt < 8; ++mt) {
        uint32_t a[4];
        uaes::ldmatrix_x4(a, pa + 16 * mt * uaes::kL1Stride + 8 * kc);
        uaes::mma_and_popc(acc[mt][0], a, b[0], b[1]);
        uaes::mma_and_popc(acc[mt][1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 8; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int o = 16 * mt + g + 8 * (i >> 1);
          const int n = row0 + 16 * pass + 8 * nt + 2 * tig + (i & 1);
          if (n < w) s1[static_cast<size_t>(o) * w + n] = static_cast<int8_t>(acc[mt][nt][i] & 1u);
        }
  }
}

// MODE 0: level1_row; 1: the binary tensor-core product; 2: the loads alone;
// 3: the product with its first form of stores
template <int MODE>
__global__ void __launch_bounds__(kRows, 1)
gate_kernel(const uint32_t* __restrict__ planes, const uint32_t* __restrict__ ghmask,
            const uint32_t* __restrict__ w1p, int8_t* __restrict__ s1, int w) {
  extern __shared__ uint32_t smem[];
  uint32_t* w1s = smem;
  uint32_t* stage = smem + 128 * uaes::kL1Stride;
  const int stride = MODE == 1 || MODE == 3 ? uaes::kL1Stride : 128;
  if (MODE != 2)
    for (int i = threadIdx.x; i < 128 * 128; i += blockDim.x) w1s[(i >> 7) * stride + (i & 127)] = w1p[i];
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool live = row < w;
  uint32_t s[8][16];
  const uint4* src = reinterpret_cast<const uint4*>(planes + static_cast<size_t>(row) * 128);
#pragma unroll
  for (int q4 = 0; q4 < 32; ++q4) {
    const uint4 v = live ? __ldg(src + q4) : make_uint4(0u, 0u, 0u, 0u);
    const int q = 4 * q4;
    s[q / 16][q % 16] = v.x; s[q / 16][q % 16 + 1] = v.y;
    s[q / 16][q % 16 + 2] = v.z; s[q / 16][q % 16 + 3] = v.w;
  }
  const uint32_t ghm = live ? ghmask[row] : 0u;
  __syncthreads();
  if (MODE == 0) {
    level1_row(s, ghm, w1s, s1, row, w, live);
  } else if (MODE == 1 || MODE == 3) {
    const int first = threadIdx.x & ~31;
    uaes::stage_level1_row(s, ghm, stage + threadIdx.x * uaes::kL1Stride);
    __syncwarp();
    if (MODE == 1)
      uaes::level1_mma_warp(w1s, stage + first * uaes::kL1Stride, s1, blockIdx.x * kRows + first, w);
    else
      level1_mma_direct(w1s, stage + first * uaes::kL1Stride, s1, blockIdx.x * kRows + first, w);
  } else {
    uint32_t x = 0u;
#pragma unroll
    for (int b = 0; b < 8; ++b)
#pragma unroll
      for (int p = 0; p < 16; ++p) x ^= s[b][p] & ghm;
    if (live) s1[row] = static_cast<int8_t>(__popc(x) & 1);
  }
}

template <int MODE>
int launch(const uint32_t* planes, const uint32_t* ghm, const uint32_t* w1p, int8_t* s1, int w,
           cudaStream_t stream) {
  const int smem = MODE == 1 || MODE == 3 ? (128 + kRows) * uaes::kL1Stride * 4
                 : MODE == 0 ? 128 * 128 * 4 : 0;
  cudaError_t err = cudaFuncSetAttribute(gate_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gate_kernel<MODE><<<(w + kRows - 1) / kRows, kRows, smem, stream>>>(planes, ghm, w1p, s1, w);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

extern "C" int gate_level1(const uint32_t* planes, const uint32_t* ghm, const uint32_t* w1p,
                           int8_t* s1, int w, int mode, cudaStream_t stream) {
  return mode == 0 ? launch<0>(planes, ghm, w1p, s1, w, stream)
       : mode == 1 ? launch<1>(planes, ghm, w1p, s1, w, stream)
       : mode == 2 ? launch<2>(planes, ghm, w1p, s1, w, stream)
                   : launch<3>(planes, ghm, w1p, s1, w, stream);
}
"""

GATE_ROWS = 32_800  # W of K1 at 16 MiB (seal.seal_stream_words(1 << 20))


def _cuda_ms(fn, reps=10):
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps=10):
    """Milliseconds of device time per call: the CUDA kernels (and copies)
    that `reps` calls ran, from the profiler, after a warm-up call; the host's
    time between launches does not count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / reps


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]


def gate(root: Path) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, str(root.resolve()))
    from micro_aes_tpu_torch.ops import _build
    from micro_aes_tpu_torch.ops.seal_kernels import level1_plain

    csrc = root.resolve() / "micro_aes_tpu_torch" / "csrc"
    with tempfile.TemporaryDirectory() as tmp:
        src, so = Path(tmp, "gate.cu"), Path(tmp, "libgate.so")
        src.write_text(GATE_SRC)
        built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-shared",
                                "-o", str(so), str(src)], capture_output=True, text=True)
        if built.returncode:
            return {"error": built.stdout + built.stderr}
        lib = ctypes.CDLL(str(so))
    ptxas = [ln.strip() for ln in (built.stdout + built.stderr).splitlines()
             if "Used" in ln or "spill" in ln or "gate_kernel" in ln]
    lib.gate_level1.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                                        ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(11)
    w = GATE_ROWS
    planes = torch.from_numpy(rng.integers(0, 2**32, (w, 128), dtype=np.uint32)
                              .view(np.int32)).to(dev)
    ghm = torch.from_numpy(rng.integers(0, 2**32, (1, w), dtype=np.uint32).view(np.int32))
    ghm[0, :5] = torch.tensor([0, -1, 1, -2**31, 0x00FF00FF], dtype=torch.int32)
    ghm = ghm.to(dev)
    w1p = torch.from_numpy(rng.integers(0, 2**32, (128, 128), dtype=np.uint32)
                           .view(np.int32)).to(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(mode):
        s1 = torch.zeros((128, w), dtype=torch.int8, device=dev)
        err = lib.gate_level1(planes.data_ptr(), ghm.data_ptr(), w1p.data_ptr(), s1.data_ptr(),
                              w, mode, stream)
        if err:
            raise RuntimeError(f"gate: launch error {err}")
        return s1

    ref, mma, direct = run(0), run(1), run(3)
    torch.cuda.synchronize()
    plain = level1_plain(planes.T.reshape(8, 16, w).contiguous(), ghm, w1p)
    modes = (("level1_row", 0), ("level1_mma", 1), ("loads_only", 2),
             ("level1_mma_direct_stores", 3))
    ms = {name: [round(_cuda_ms(lambda m=mode: run(m)), 4) for _ in range(3)]
          for name, mode in modes}
    best = {k: min(v) for k, v in ms.items()}
    return {"checkout": str(root), "nvidia_smi": _smi(), "rows": w, "ms": ms,
            "level1_alone_ms": {k: round(best[k] - best["loads_only"], 4)
                                for k in best if k != "loads_only"},
            "mma_equals_level1_row": bool(torch.equal(ref, mma)),
            "direct_stores_equal_level1_row": bool(torch.equal(ref, direct)),
            "level1_row_equals_plain": bool(torch.equal(ref, plain)),
            "mma_equals_plain": bool(torch.equal(mma, plain)),
            "ptxas": ptxas}


# -- time ---------------------------------------------------------------------

SEED, NB = 23, 256


def _digest(x) -> str:
    import torch

    if isinstance(x, torch.Tensor):
        return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:16]
    if isinstance(x, (tuple, list)) and x and all(isinstance(v, torch.Tensor) or v is None
                                                  for v in x):
        return _digest(b"".join(bytes.fromhex(_digest(v)) for v in x if v is not None))
    if isinstance(x, list):
        x = b"".join(b"\0" if v is None else
                     (b"".join(v) if isinstance(v, tuple) else bytes(v)) for v in x)
    return hashlib.sha256(bytes(x)).hexdigest()[:16]


class _Setup:
    """The inputs of `time` and `cols`, drawn in the same order in every
    checkout."""

    def __init__(self, root: Path):
        import numpy as np
        import torch

        sys.path.insert(0, str(root.resolve()))
        from micro_aes_tpu_torch.core.bitslice import key_planes_packed
        from micro_aes_tpu_torch.modes.bulk import stack_round_keys
        from micro_aes_tpu_torch.utils.bytesio import u32_tensor

        self.dev = dev = torch.device("cuda", 0)
        self.rng = rng = np.random.default_rng(SEED)

        def u8(*shape):
            return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

        def kpw(b, klen=16):
            return u32_tensor(key_planes_packed(stack_round_keys(
                [rng.integers(0, 256, klen, dtype=np.uint8).tobytes() for _ in range(b)])), dev)

        self.u8, self.kpw = u8, kpw
        self.k15 = {}
        for b in (4096, 2048):
            k, c0, blocks = kpw(b), u8(b, 16), u8(b, NB, 16)
            c0[0, 9:] = 0xFF  # bases that carry into byte 9, and one whose carry is dropped
            c0[1, 12:] = 0xFF
            self.k15[b] = (k, c0, blocks)


def _mix_k15_calls(st: _Setup) -> tuple[list, dict]:
    """K15's calls in the ragged 256-message AEAD batches, as (kpw, c0,
    blocks, whiten) on the card, and the batches' request callables."""
    import numpy as np

    from micro_aes_tpu_torch.modes import bulk
    from micro_aes_tpu_torch.ops import aead_kernels as ak

    rng = st.rng

    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    nrag = 256
    alens = [int(x) for x in rng.integers(0, 4097, nrag)]
    alens[:4] = (0, 1, 15, 16)
    rkeys = [rand((16, 24, 32)[i % 3]) for i in range(nrag)]
    rskeys = [k + rand(len(k)) for k in rkeys]
    rnonces = [rand(11 + i % 3) for i in range(nrag)]
    raads = [rand(int(x)) for x in rng.integers(0, 41, nrag)]
    rpts = [rand(n) for n in alens]
    dev = st.dev
    rccm = bulk.ccm_encrypt_batch(rkeys, rnonces, raads, rpts, device=dev)
    reax = bulk.eax_encrypt_batch(rkeys, rnonces, raads, rpts, device=dev)
    rsiv = bulk.siv_encrypt_batch(rskeys, raads, rpts, device=dev)
    requests = {
        "ragged_ccm_seal": lambda: bulk.ccm_encrypt_batch(rkeys, rnonces, raads, rpts, device=dev),
        "ragged_ccm_open": lambda: bulk.ccm_decrypt_batch(rkeys, rnonces, raads, rccm, device=dev),
        "ragged_eax_seal": lambda: bulk.eax_encrypt_batch(rkeys, rnonces, raads, rpts, device=dev),
        "ragged_eax_open": lambda: bulk.eax_decrypt_batch(rkeys, rnonces, raads, reax, device=dev),
        "ragged_siv_seal": lambda: bulk.siv_encrypt_batch(rskeys, raads, rpts, device=dev),
        "ragged_siv_open": lambda: bulk.siv_decrypt_batch(
            rskeys, [s[0] for s in rsiv], raads, [s[1] for s in rsiv], device=dev),
    }
    calls, real = [], ak.ctr_packed_fused

    def record(kpw, c0, blocks, whiten=False):
        calls.append((kpw.clone(), c0.clone(), blocks.clone(), whiten))
        return real(kpw, c0, blocks, whiten)

    record.launches = 0
    ak.ctr_packed_fused = record
    try:
        for fn in requests.values():
            fn()
    finally:
        ak.ctr_packed_fused = real
    return calls, requests


def timed(root: Path) -> dict:
    import time

    import numpy as np
    import torch

    st = _Setup(root)
    from micro_aes_tpu_torch.modes import bulk, seal
    from micro_aes_tpu_torch.ops import _build
    from micro_aes_tpu_torch.ops import aead_kernels as ak
    from micro_aes_tpu_torch.ops.counter import j0_planes, lohi_words
    from micro_aes_tpu_torch.ops.seal_kernels import ctr_fused, seal_fused

    dev, rng, u8, kpw = st.dev, st.rng, st.u8, st.kpw

    def host_s(fn, reps=5):
        fn()
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(round(time.perf_counter() - t0, 5))
        return out

    kernels = {}
    for b, (k, c0, blocks) in st.k15.items():
        kernels[f"k15_{b}x{NB}"] = lambda a=(k, c0, blocks): ak.ctr_packed_fused(*a)
        kernels[f"k15_{b}x{NB}_whiten"] = lambda a=(k, c0, blocks): ak.ctr_packed_fused(*a, True)
    # K11 at 2048 x 256 and K12 at 4096 x 256 (AES-128), as the batches call them
    for b, names in ((2048, ("ccm", "eax")), (4096, ("siv",))):
        km, kc = kpw(b), kpw(b)
        c0, init, tail, lastadd, prevadd = (u8(b, 16) for _ in range(5))
        blocks = u8(b, NB, 16)
        nv = np.maximum(rng.integers(0, NB + 1, b).astype(np.int32), 1)
        nvalid = torch.from_numpy(nv).to(dev)
        if names == ("siv",):
            kernels["k12_seal"] = lambda a=(km, kc, init, blocks, nvalid, tail, lastadd,
                                            prevadd): ak.siv_seal_chain_fused(*a)
            kernels["k12_open"] = lambda a=(km, kc, c0, init, blocks, nvalid, tail, lastadd,
                                            prevadd): ak.siv_open_chain_fused(*a)
            continue
        for kind in names:
            for decrypt in (False, True):
                kernels[f"k11_{kind}{'_open' if decrypt else ''}"] = \
                    lambda a=(kind, km, c0, init, blocks, nvalid, tail, lastadd, decrypt): \
                    ak.aead_chain_fused(*a)
    # K1 (seal, open) and K3 at 16 MiB
    n = 1 << 20
    w_seal, w_ctr = seal.seal_stream_words(n), seal.stream_words(n + 1)
    for klen in (32, 16):
        key = rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
        kp, tables = seal.gcm_key_setup(key, device=dev)
        kpf = kp.reshape(-1, 1)
        j0 = seal._j0_block(rng.integers(0, 256, 12, dtype=np.uint8).tobytes(), dev)
        j0c = j0_planes(j0)
        lohi, lohi_c = lohi_words(j0, w_seal, -1), lohi_words(j0, w_ctr, -1)
        ghm = seal.ghash_mask(n - 5, w_seal, dev)  # a partial last row
        pt = torch.from_numpy(rng.integers(-2**31, 2**31, (w_seal, 128), dtype=np.int64)
                              .astype(np.int32)).to(dev)
        ptc = torch.from_numpy(rng.integers(-2**31, 2**31, (w_ctr, 128), dtype=np.int64)
                               .astype(np.int32)).to(dev)
        aes = 8 * klen
        for opening in (False, True):
            kernels[f"k1_{'open' if opening else 'seal'}_aes{aes}"] = \
                lambda a=(kpf, j0c, lohi, ghm, tables[5], pt, opening): seal_fused(*a)
        kernels[f"k3_aes{aes}"] = lambda a=(kpf, j0c, lohi_c, ptc): ctr_fused(*a)
    ms, dev_ms, sha = {}, {}, {}
    for name, fn in kernels.items():
        sha[name] = _digest(fn())
        ms[name] = [round(_cuda_ms(fn), 4) for _ in range(3)]
        dev_ms[name] = [round(_device_ms(fn), 4) for _ in range(2)]
    # K15's calls in the ragged AEAD batches, each replayed alone
    calls, requests = _mix_k15_calls(st)
    per = [min(_device_ms(lambda c=c: ak.ctr_packed_fused(*c)) for _ in range(2)) for c in calls]
    dev_ms["k15_mix_sum"] = round(sum(per), 4)
    dev_ms["k15_mix_calls"] = [round(x, 4) for x in per]
    shapes = [[int(c[2].shape[0]), int(c[2].shape[1]), int(c[0].shape[0] - 1), c[3]]
              for c in calls]
    outs = []
    for c in calls:
        r = ak.ctr_packed_fused(*c)
        outs.extend(r if isinstance(r, tuple) else (r,))
    sha["k15_mix"] = _digest(outs)
    # K10's cipher half on K15's 4096 x 256 inputs: the profiler's device time
    k, c0, blocks = st.k15[4096]
    b, w = blocks.shape[0], blocks.shape[0] // 32
    lib = _build.load()
    zero = torch.zeros((16384, w), dtype=torch.int32, device=dev)
    zm = torch.zeros((NB, w), dtype=torch.int32, device=dev)
    rows = [torch.zeros((b, 16), dtype=torch.uint8, device=dev) for _ in range(3)]
    out, g = torch.empty_like(blocks), torch.empty((b, 16), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def k10():
        err = lib.micro_aes_gcm_chain(k.data_ptr(), zero.data_ptr(), c0.data_ptr(),
                                      rows[0].data_ptr(), blocks.data_ptr(), zm.data_ptr(),
                                      zm.data_ptr(), zm.data_ptr(), zm.data_ptr(),
                                      rows[1].data_ptr(), rows[2].data_ptr(), out.data_ptr(),
                                      g.data_ptr(), 10, b, NB, 0, stream)
        if err:
            raise RuntimeError(f"gcm_chain: launch error {err}")
        return out

    k10()
    sha["k10_cipher_on_k15_4096"] = _digest(out)
    sha["k15_4096_equals_k10_cipher"] = bool(torch.equal(out, ak.ctr_packed_fused(k, c0, blocks)))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            k10()
        torch.cuda.synchronize()
    dev_us = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        for short in ("chain_cipher_kernel", "chain_fold_kernel"):
            if short in e.key:
                dev_us[short] = dev_us.get(short, 0) + us
    ms["k10_cipher_on_k15_4096_profiler"] = round(dev_us.get("chain_cipher_kernel", 0) / 1e4, 4)
    ms["k10_fold_zero_tables_profiler"] = round(dev_us.get("chain_fold_kernel", 0) / 1e4, 4)
    # requests on the host clock
    def rand(nbytes):
        return rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()

    size = 16 * NB
    blob = rand(4096 * size)
    apts = [blob[i * size:(i + 1) * size] for i in range(4096)]
    akeys, anonces = [rand(16) for _ in range(2048)], [rand(12) for _ in range(2048)]
    skeys = [rand(32) for _ in range(4096)]
    gkey, gnonce, gpt = rand(32), rand(12), rand(16 << 20)
    gblob = seal.gcm_seal(gkey, gnonce, gpt, b"hdr", device=dev)
    requests.update({
        "ccm_2048x4KiB_seal": lambda: bulk.ccm_encrypt_batch(
            akeys, [x[:11] for x in anonces], [b"hdr"] * 2048, apts[:2048], device=dev),
        "eax_2048x4KiB_seal": lambda: bulk.eax_encrypt_batch(akeys, anonces, [b"hdr"] * 2048,
                                                             apts[:2048], device=dev),
        "siv_4096x4KiB_seal": lambda: bulk.siv_encrypt_batch(skeys, [b"hdr"] * 4096, apts,
                                                             device=dev),
        "gcm_seal_16MiB": lambda: seal.gcm_seal(gkey, gnonce, gpt, b"hdr", device=dev),
        "gcm_open_16MiB": lambda: seal.gcm_open(gkey, gnonce, gblob, b"hdr", device=dev),
    })
    secs = {}
    for name, fn in requests.items():
        sha[name] = _digest(fn())
        secs[name] = host_s(fn)
    return {"checkout": str(root), "nvidia_smi": _smi(), "kernel_ms": ms, "device_ms": dev_ms,
            "k15_mix_shapes": shapes, "host_s": secs, "sha256": sha}


def cols(root: Path) -> dict:
    """K15 with its thread layout forced, where the C entry takes it: device
    ms (profiler, min of two means of 10) per layout and shape, with
    digests, each output held against the plain version on the card."""
    import torch

    st = _Setup(root)
    from micro_aes_tpu_torch.ops import _build
    from micro_aes_tpu_torch.ops import aead_kernels as ak

    lib = _build.load()
    stream = torch.cuda.current_stream(st.dev).cuda_stream
    cases = {f"{b}x{NB}": st.k15[b] for b in st.k15}
    for b in (1024, 512, 256, 96):  # between the big batches and the ragged mix's calls
        cases[f"{b}x{NB}"] = (st.kpw(b), st.u8(b, 16), st.u8(b, NB, 16))
    for b, nb in ((4096, 16), (4096, 1)):  # short messages
        cases[f"{b}x{nb}"] = (st.kpw(b), st.u8(b, 16), st.u8(b, nb, 16))
    calls, _ = _mix_k15_calls(st)

    def runner(k, c0, blocks, whiten, ncols):
        out, wh = torch.empty_like(blocks), torch.empty_like(c0) if whiten else None

        def run():
            err = lib.micro_aes_ctr_packed(k.data_ptr(), c0.data_ptr(), blocks.data_ptr(),
                                           out.data_ptr(), None if wh is None else wh.data_ptr(),
                                           k.shape[0] - 1, k.shape[3], blocks.shape[1], ncols,
                                           stream)
            if err:
                raise RuntimeError(f"ctr_packed: launch error {err}")
            return (out, wh) if whiten else out

        return run

    want = {(name, whiten): _digest(ak.ctr_packed_fused_plain(*case, whiten))
            for name, case in cases.items() for whiten in (False, True)}
    ms, sha, same = {}, {}, {}
    for ncols in (0, 4, 2, 1):
        for whiten in (False, True):
            for name, (k, c0, blocks) in cases.items():
                run = runner(k, c0, blocks, whiten, ncols)
                key = f"{name}{'_whiten' if whiten else ''}_cols{ncols}"
                sha[key] = _digest(run())
                same[key] = sha[key] == want[name, whiten]
                ms[key] = round(min(_device_ms(run) for _ in range(2)), 4)
        per = [min(_device_ms(runner(k, c0, blocks, whiten, ncols)) for _ in range(2))
               for k, c0, blocks, whiten in calls]
        ms[f"mix_sum_cols{ncols}"] = round(sum(per), 4)
        ms[f"mix_calls_cols{ncols}"] = [round(x, 4) for x in per]
    return {"checkout": str(root), "nvidia_smi": _smi(), "device_ms": ms,
            "equal_to_plain": same, "sha256": sha}


def main() -> int:
    args = sys.argv[1:]
    if not args or args[0] not in ("sass", "gate", "time", "cols", "ab"):
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
        return 0
    import torch

    if not torch.cuda.is_available():
        print("k15_k1_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    fn = {"gate": gate, "time": timed, "cols": cols}[args[0]]
    print(json.dumps(fn(root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
