#!/usr/bin/env python3
"""K6 (xex_fused.cu, the XTS body) and K5-open (siv_fused.cu, the one-pass
GCM-SIV open) of micro_aes_tpu_torch, beside the kernels that share their
bodies (K8, K7, K5, K4, K3, K1), for comparing two checkouts on one NVIDIA
GPU.

    python3 tools/k6_k5o_ab.py sass [CHECKOUT_ROOT] [--dump FILE]
    python3 tools/k6_k5o_ab.py probe [CHECKOUT_ROOT]
    python3 tools/k6_k5o_ab.py time [CHECKOUT_ROOT]
    python3 tools/k6_k5o_ab.py ab PARENT_ROOT CHANGE_ROOT

`sass` builds the checkout's kernels and counts, from `cuobjdump -sass` of the
library, the instructions of the XEX bodies (`xex_body_kernel*`: K6, K7,
K8), K3 (`ctr_fused_kernel`), K5 and K5-open (`siv_ctr_kernel*`, and
`siv_open_kernel` where the checkout has it), K4
(`ghash1_fused_kernel`) and K1 (`seal_fused_kernel*`): the whole function
and every loop (a backward branch), innermost first, by class (LOP3, SHF,
other ALU, memory by kind and width, spill LDL/STL, MMA), and an estimate
of the instructions a thread (one 32-block row) runs at AES-256: the
function once, plus 12 more passes of its round loop (the loop with over
1,000 LOP3) and 127 more of `level1_row`'s loop (32 LDS.128 and over 100
LOP3), with nvcc's `-Xptxas -v` lines for them.  --dump writes their SASS
to FILE.

`probe` builds micro-kernels from the checkout's csrc/aes_bitslice.cuh, 128
rows a block as K8 has them, at W = 32,768 rows (16 MiB): (0) K8's body as
xex_fused.cu has it (the xor stream staged in the row's slot, the input row
read by the thread itself, 32 16-byte loads at a 512-byte stride), (1) K8's
body with the input row staged coalesced through the slot first (turned
into planes, then the xor stream staged), (2) K6 with its offsets made in
the word domain in the slot (a funnel shift by jj and the 0x87 fold of the
jj bits that fall out of word 3, block jj of the row), the input as (0),
and (3) K6 with the base rows and then the input rows staged coalesced
through the slot, the offsets held in registers in between.  Each runs both
directions at AES-256, is held bit for bit against the plain version
(ctrw_fused_plain, xex_fused_plain) and the checkout's own K8/K6, and is
timed (CUDA events, three means of 10) beside the checkout's K8 and K6.

`time` runs, with random keys and data at chip_smoke.py's shapes (CUDA
events, three means of 10 after a warm-up; the profiler's device time, two
means of 10): K6 and K8 both ways, K7 both ways (nbits = 21) at the 16 MiB
stream (W = 32,768), AES-256 and AES-128; K5-open at the 16 MiB GCM-SIV
stream (W = 32,800) AES-256 and AES-128 and with a counter base that wraps
at row W/2; K5 and K4 there; K3 and K1 (seal, open) at 16 MiB AES-256;
and on the host clock (five warm calls) xts_seal_sectors/xts_open_sectors
of 16 MiB as 4 KiB sectors (AES-256 XTS) and gcm_siv_open of 16 MiB (AES-256,
warm key and nonce).  It prints one JSON line with the checkout, the card's
nvidia-smi line, the times and a SHA-256 of each output: two checkouts that
agree bit for bit print the same digests.

`ab` runs `time` on the parent, the change, the change and the parent, each
in its own process, one after another on the same card.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve()
sys.path.insert(0, str(HERE.parent))

from k15_k1_ab import _cuda_ms, _device_ms, _digest, _mem_widths, _smi  # noqa: E402
from spread_ab import _code, _counts, loops  # noqa: E402

_KERNELS = ("xex_body_kernel", "ctr_fused_kernel", "siv_ctr_kernel", "siv_open_kernel",
            "ghash1_fused_kernel", "seal_fused_kernel")
_MMA = ("HMMA", "IMMA", "BMMA")
AES256_EXTRA_ROUNDS = 12  # the round loop's static copy is one of 13 passes
LEVEL1_EXTRA = 127        # level1_row's loop: 128 outputs


def _classes(body: list[str]) -> dict:
    c = _counts(body)
    by = c["by_op"]
    c["shf"] = by.get("SHF", 0)
    c["mma"] = sum(by.get(op, 0) for op in _MMA)
    c["spill_ldl_stl"] = by.get("LDL", 0) + by.get("STL", 0)
    c["mem"] = _mem_widths(body)
    return c


def function_counts(func: str) -> dict:
    code = _code(func)
    body = [t for _, t in code]
    fn = _classes(body)
    ls, per_row = [], dict(fn)
    for d in loops(func):
        lo, hi = d["span"]
        lc = _classes([t for a, t in code if lo <= a <= hi])
        role, extra = None, 0
        if lc["lop3"] > 1000:
            role, extra = "round", AES256_EXTRA_ROUNDS
        elif lc["mem"].get("LDS.128", 0) == 32 and lc["lop3"] > 100 and not lc["mma"]:
            role, extra = "level1_row", LEVEL1_EXTRA
        ls.append({"span": d["span"], "role": role, **lc})
        if extra:
            for k in ("total", "lop3", "shf", "other_alu", "lds_sts", "ldg_stg", "branch_loop"):
                per_row[k] = per_row[k] + extra * lc[k]
    per_row = {k: per_row[k] for k in ("total", "lop3", "shf", "other_alu", "lds_sts",
                                       "ldg_stg", "branch_loop", "mma", "spill_ldl_stl")}
    return {"function": fn, "loops": ls, "per_row_aes256_estimate": per_row}


def _demangle(names: list[str]) -> dict:
    tool = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    try:
        out = subprocess.run([tool, *names], capture_output=True, text=True, check=True).stdout
        return dict(zip(names, out.splitlines()))
    except (OSError, subprocess.CalledProcessError):
        return {n: n for n in names}


def sass(root: Path, dump: Path | None) -> dict:
    sys.path.insert(0, str(root.resolve()))
    from micro_aes_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:  # a fresh build, for nvcc's -Xptxas -v lines
        _build.BUILD_DIR = Path(tmp)
        lib = Path(shutil.copy(_build.build(), Path(tempfile.gettempdir(), "k6_k5o_sass.so")))
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    found, kept = {}, []
    for func in re.split(r"\n\s*Function : ", text):
        name = func.split("\n", 1)[0].strip()
        if any(k in name for k in _KERNELS):
            found[name] = function_counts(func)
            kept.append(f"Function : {func}")
    if dump:
        dump.parent.mkdir(parents=True, exist_ok=True)
        dump.write_text("\n".join(kept))
    names = _demangle(list(found))
    ptxas, cur = [], None
    for ln in _build.build_info.log.splitlines():
        if "Function properties for" in ln:
            cur = ln.split("for", 1)[1].strip()
        elif cur and any(k in cur for k in _KERNELS) and ("Used" in ln or "spill" in ln):
            ptxas.append(f"{names.get(cur, cur)}: {ln.strip()}")
    return {"checkout": str(root), "library": lib.name,
            "kernels": {names[n]: v for n, v in found.items()}, "ptxas": ptxas}


# -- probe --------------------------------------------------------------------

PROBE_SRC = r"""
#include <cuda_runtime.h>
#include "aes_bitslice.cuh"

namespace {
constexpr int kRows = 128;

// xex_fused.cu's input path: the row read by its thread, 16 bytes a block
template <bool PRE_XOR>
__device__ __forceinline__ void load_row_planes(uint32_t (&s)[8][16],
                                                const uint32_t* __restrict__ in,
                                                const uint32_t* slot, int row, bool live) {
  uint32_t a[4][32];
  const uint4* src = reinterpret_cast<const uint4*>(in) + static_cast<size_t>(row) * 32;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const uint4 v = live ? __ldg(src + j) : make_uint4(0u, 0u, 0u, 0u);
    a[0][j] = v.x; a[1][j] = v.y; a[2][j] = v.z; a[3][j] = v.w;
    if (PRE_XOR) {
#pragma unroll
      for (int k = 0; k < 4; ++k) a[k][j] ^= slot[4 * j + k];
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uaes::transpose32(a[k]);
#pragma unroll
    for (int r = 0; r < 32; ++r) s[r % 8][4 * k + r / 8] = a[k][r];
  }
}

__device__ __forceinline__ void xor_planes_into_row(const uint32_t (&s)[8][16], uint32_t* slot) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t a[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) a[r] = s[r % 8][4 * k + r / 8];
    uaes::transpose32(a);
#pragma unroll
    for (int j = 0; j < 32; ++j) slot[4 * j + k] ^= a[j];
  }
}

// block * alpha^jj, 1 <= jj <= 31, little-endian words: one funnel shift, and
// the jj bits that fall out of word 3 folded back with x^128 = x^7+x^2+x+1
// (under 2^38: words 0 and 1; ov >> 31 is always 0)
__device__ __forceinline__ void alpha_pow(uint32_t (&v)[4], int jj) {
  const uint32_t ov = v[3] >> (32 - jj);
  v[3] = __funnelshift_l(v[2], v[3], jj);
  v[2] = __funnelshift_l(v[1], v[2], jj);
  v[1] = __funnelshift_l(v[0], v[1], jj);
  v[0] = (v[0] << jj) ^ ov ^ (ov << 1) ^ (ov << 2) ^ (ov << 7);
  v[1] ^= (ov >> 30) ^ (ov >> 25);
}

template <int MODE, bool DECRYPT>
__global__ void __launch_bounds__(kRows)
probe_kernel(const uint32_t* __restrict__ kp, const uint32_t* __restrict__ a,
             const uint32_t* __restrict__ b, uint32_t* __restrict__ out, int rounds, int w) {
  // K8: a = the cipher's input blocks, b = the xor stream; K6: a = bases, b = input
  extern __shared__ uint32_t smem[];
  uint32_t* kps = smem;
  uint32_t* slots = kps + uaes::kMaxKeyPlaneWords;
  const int w0 = blockIdx.x * kRows;
  const int row = w0 + threadIdx.x;
  uint32_t* slot = slots + threadIdx.x * uaes::kStageStride;
  uaes::copy_to_smem(kp, kps, (rounds + 1) * 128);
  uint32_t s[8][16];
  if (MODE == 0) {
    uaes::stage_rows_in(b, slots, w0, kRows, w);
    __syncthreads();
    load_row_planes<false>(s, a, slot, row, row < w);
  } else if (MODE == 1) {
    uaes::stage_rows_in(a, slots, w0, kRows, w);
    __syncthreads();
    uaes::row_to_planes(s, slot);
    __syncthreads();
    uaes::stage_rows_in(b, slots, w0, kRows, w);
    __syncthreads();
  } else if (MODE == 2) {
    uaes::stage_rows_in(a, slots, w0, kRows, w);
    __syncthreads();
#pragma unroll
    for (int jj = 1; jj < 32; ++jj) {
      uint32_t v[4] = {slot[4 * jj], slot[4 * jj + 1], slot[4 * jj + 2], slot[4 * jj + 3]};
      alpha_pow(v, jj);
#pragma unroll
      for (int k = 0; k < 4; ++k) slot[4 * jj + k] = v[k];
    }
    load_row_planes<true>(s, b, slot, row, row < w);
  } else {
    uaes::stage_rows_in(a, slots, w0, kRows, w);
    __syncthreads();
    uint32_t off[32][4];
#pragma unroll
    for (int jj = 0; jj < 32; ++jj) {
#pragma unroll
      for (int k = 0; k < 4; ++k) off[jj][k] = slot[4 * jj + k];
      if (jj) alpha_pow(off[jj], jj);
    }
    __syncthreads();
    uaes::stage_rows_in(b, slots, w0, kRows, w);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t t[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        t[j] = slot[4 * j + k] ^ off[j][k];
        slot[4 * j + k] = off[j][k];
      }
      uaes::transpose32(t);
#pragma unroll
      for (int r = 0; r < 32; ++r) s[r % 8][4 * k + r / 8] = t[r];
    }
  }
  if (DECRYPT) {
    uaes::decrypt_state(s, kps, rounds);
  } else {
    uaes::encrypt_state(s, kps, rounds);
  }
  xor_planes_into_row(s, slot);
  __syncthreads();
  uaes::stage_rows_out(slots, out, w0, kRows, w);
}

template <int MODE, bool DECRYPT>
int launch(const uint32_t* kp, const uint32_t* a, const uint32_t* b, uint32_t* out, int rounds,
           int w, cudaStream_t stream) {
  const int smem = (uaes::kMaxKeyPlaneWords + kRows * uaes::kStageStride) * 4;
  cudaError_t err = cudaFuncSetAttribute(probe_kernel<MODE, DECRYPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_kernel<MODE, DECRYPT><<<(w + kRows - 1) / kRows, kRows, smem, stream>>>(kp, a, b, out,
                                                                                rounds, w);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_dir(const uint32_t* kp, const uint32_t* a, const uint32_t* b, uint32_t* out, int rounds,
               int w, int decrypt, cudaStream_t stream) {
  return decrypt ? launch<MODE, true>(kp, a, b, out, rounds, w, stream)
                 : launch<MODE, false>(kp, a, b, out, rounds, w, stream);
}
}  // namespace

extern "C" int probe_xex(const uint32_t* kp, const uint32_t* a, const uint32_t* b, uint32_t* out,
                         int rounds, int w, int mode, int decrypt, cudaStream_t stream) {
  switch (mode) {
    case 0: return launch_dir<0>(kp, a, b, out, rounds, w, decrypt, stream);
    case 1: return launch_dir<1>(kp, a, b, out, rounds, w, decrypt, stream);
    case 2: return launch_dir<2>(kp, a, b, out, rounds, w, decrypt, stream);
    default: return launch_dir<3>(kp, a, b, out, rounds, w, decrypt, stream);
  }
}
"""

XEX_ROWS = 32_768  # W of K6/K7/K8 at 16 MiB


def probe(root: Path) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, str(root.resolve()))
    from micro_aes_tpu_torch.modes import seal
    from micro_aes_tpu_torch.ops import _build
    from micro_aes_tpu_torch.ops import xex_kernels as xk

    csrc = root.resolve() / "micro_aes_tpu_torch" / "csrc"
    with tempfile.TemporaryDirectory() as tmp:
        src, so = Path(tmp, "probe.cu"), Path(tmp, "libprobe.so")
        src.write_text(PROBE_SRC)
        built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-shared",
                                "-o", str(so), str(src)], capture_output=True, text=True)
        if built.returncode:
            return {"error": built.stdout + built.stderr}
        lib = ctypes.CDLL(str(so))
    ptxas, cur = [], None
    for ln in (built.stdout + built.stderr).splitlines():
        if "Function properties for" in ln:
            cur = ln.split("for", 1)[1].strip()
        elif cur and ("Used" in ln or "spill" in ln):
            ptxas.append(f"{cur}: {ln.strip()}")
    lib.probe_xex.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(12)
    w = XEX_ROWS
    key = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    kp, _ = seal.gcm_key_setup(key, device=dev)
    kpf = kp.reshape(-1, 1)
    rounds = kp.shape[0] - 1

    def words(*shape):
        return torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint32)
                                .view(np.int32)).to(dev)

    a, b = words(w, 128), words(w, 128)
    a[:64, 12::4] = -2**31            # bases whose word 3 overflows at every jj
    a[64:128, 12::4] = -1
    a[128:192] = -1
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty_like(a)

    def run(mode, decrypt):
        err = lib.probe_xex(kpf.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), rounds,
                            w, mode, int(decrypt), stream)
        if err:
            raise RuntimeError(f"probe: launch error {err}")
        return out

    names = {0: "k8_input_read_per_thread", 1: "k8_input_staged", 2: "k6_words_input_per_thread",
             3: "k6_words_all_staged"}
    ms, same = {}, {}
    for decrypt in (False, True):
        sfx = "_dec" if decrypt else ""
        want = {0: xk.ctrw_fused_plain(kpf, a, b, decrypt),
                2: xk.xex_fused_plain(kpf, a, b, decrypt)}
        lib_out = {0: xk.ctrw_fused(kpf, a, b, decrypt), 2: xk.xex_fused(kpf, a, b, decrypt)}
        for mode, name in names.items():
            got = run(mode, decrypt).clone()
            ref = 0 if mode < 2 else 2
            same[name + sfx] = (bool(torch.equal(got, want[ref]))
                                and bool(torch.equal(got, lib_out[ref])))
            ms[name + sfx] = [round(_cuda_ms(lambda m=mode: run(m, decrypt)), 4) for _ in range(3)]
        ms["checkout_k8" + sfx] = [round(_cuda_ms(lambda: xk.ctrw_fused(kpf, a, b, decrypt)), 4)
                                  for _ in range(3)]
        ms["checkout_k6" + sfx] = [round(_cuda_ms(lambda: xk.xex_fused(kpf, a, b, decrypt)), 4)
                                  for _ in range(3)]
    return {"checkout": str(root), "nvidia_smi": _smi(), "rows": w, "ms": ms,
            "equal_to_plain_and_checkout": same, "ptxas": ptxas}


# -- time ---------------------------------------------------------------------

SEED = 29


def timed(root: Path) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, str(root.resolve()))
    from micro_aes_tpu_torch.modes import seal, siv_seal, xts_bulk
    from micro_aes_tpu_torch.modes.seal import position_mask
    from micro_aes_tpu_torch.ops import siv_kernels as sk
    from micro_aes_tpu_torch.ops import xex_kernels as xk
    from micro_aes_tpu_torch.ops.counter import j0_planes, lohi_words
    from micro_aes_tpu_torch.ops.seal_kernels import ctr_fused, seal_fused

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    def words(*shape):
        return torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint32)
                                .view(np.int32)).to(dev)

    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    kernels = {}
    # K6, K8, K7 at the 16 MiB stream
    w = 1 << 15
    nbits = (32 * w).bit_length()
    for klen in (32, 16):
        kp, _ = seal.gcm_key_setup(rand(klen), device=dev)
        kpf, aes = kp.reshape(-1, 1), 8 * klen
        x, y = words(w, 128), words(w, 128)
        y[:64, 12::4] = -2**31  # bases whose word 3 overflows at every jj
        d0l, lbl = words(1, 128), words(nbits, 128)
        for decrypt in (False, True):
            sfx = f"_aes{aes}{'_dec' if decrypt else ''}"
            kernels["k6" + sfx] = lambda a=(kpf, y, x, decrypt): xk.xex_fused(*a)
            kernels["k8" + sfx] = lambda a=(kpf, y, x, decrypt): xk.ctrw_fused(*a)
            kernels["k7" + sfx] = lambda a=(kpf, d0l, lbl, x, nbits, decrypt): xk.ocb_fused(*a)
    # K5-open, K5, K4 at the 16 MiB GCM-SIV stream
    n = 1 << 20
    ws = siv_seal._stream_words(n)
    front = 32 * ws - (n + 1)
    ghm_seal = position_mask(ws, front, 32 * ws, dev)
    ghm_open = position_mask(ws, front, 32 * ws - 1, dev)
    for klen in (32, 16):
        _, kp, tables = siv_seal._siv_key_setup(rand(klen), rand(12), dev)
        kpf, w1p, aes = kp.reshape(-1, 1), tables[5], 8 * klen
        basew = siv_seal._siv_basew(words(4), front)
        xs = words(ws, 128)
        kernels[f"k5open_aes{aes}"] = \
            lambda a=(kpf, basew, ghm_open, w1p, xs): sk.siv_open_fused(*a)
        if klen == 32:
            wrap = basew.clone()
            wrap[0, 0::4] = -32 * (ws // 2)
            kernels["k5open_aes256_wrap"] = \
                lambda a=(kpf, wrap, ghm_open, w1p, xs): sk.siv_open_fused(*a)
            kernels["k5_aes256"] = lambda a=(kpf, basew, xs): sk.siv_ctrw_fused(*a)
            kernels["k4"] = lambda a=(ghm_seal, w1p, xs): sk.ghash1_fused(*a)
    # K3 and K1 at 16 MiB AES-256
    kp, tables = seal.gcm_key_setup(rand(32), device=dev)
    kpf = kp.reshape(-1, 1)
    w_seal, w_ctr = seal.seal_stream_words(n), seal.stream_words(n + 1)
    j0 = seal._j0_block(rand(12), dev)
    j0c = j0_planes(j0)
    lohi, lohi_c = lohi_words(j0, w_seal, -1), lohi_words(j0, w_ctr, -1)
    ghm = seal.ghash_mask(n - 5, w_seal, dev)
    pt, ptc = words(w_seal, 128), words(w_ctr, 128)
    kernels["k3_aes256"] = lambda: ctr_fused(kpf, j0c, lohi_c, ptc)
    for opening in (False, True):
        kernels[f"k1_{'open' if opening else 'seal'}_aes256"] = \
            lambda o=opening: seal_fused(kpf, j0c, lohi, ghm, tables[5], pt, o)
    ms, dev_ms, sha = {}, {}, {}
    for name, fn in kernels.items():
        sha[name] = _digest(fn())
        ms[name] = [round(_cuda_ms(fn), 4) for _ in range(3)]
        dev_ms[name] = [round(_device_ms(fn), 4) for _ in range(2)]

    # requests on the host clock
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

    xkeys, data = rand(64), rand(16 << 20)
    ids = [int(i) for i in rng.integers(0, 2**40, 4096)]
    xct = xts_bulk.xts_seal_sectors(xkeys, ids, data, 4096, device=dev)
    skey, snonce = rand(32), rand(12)
    sblob = siv_seal.gcm_siv_seal(skey, snonce, data, device=dev)
    requests = {
        "xts_seal_16MiB_4KiB": lambda: xts_bulk.xts_seal_sectors(xkeys, ids, data, 4096,
                                                                 device=dev),
        "xts_open_16MiB_4KiB": lambda: xts_bulk.xts_open_sectors(xkeys, ids, xct, 4096, device=dev),
        "gcm_siv_open_16MiB": lambda: siv_seal.gcm_siv_open(skey, snonce, sblob, device=dev),
    }
    secs = {}
    for name, fn in requests.items():
        sha[name] = _digest(fn())
        secs[name] = host_s(fn)
    return {"checkout": str(root), "nvidia_smi": _smi(), "kernel_ms": ms, "device_ms": dev_ms,
            "host_s": secs, "sha256": sha}


def main() -> int:
    args = sys.argv[1:]
    if not args or args[0] not in ("sass", "probe", "time", "ab"):
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
        print("k6_k5o_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    fn = {"probe": probe, "time": timed}[args[0]]
    print(json.dumps(fn(root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
