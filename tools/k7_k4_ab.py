#!/usr/bin/env python3
"""K7 (xex_fused.cu, the OCB body) and K4 (siv_fused.cu, the level-1
POLYVAL pass of the GCM-SIV seal) of micro_aes_tpu_torch, beside the
kernels that share their bodies or their shape (K8, K6, K3, K5, K5-open,
K1), for comparing two checkouts on one NVIDIA GPU.

    python3 tools/k7_k4_ab.py sass [CHECKOUT_ROOT] [--dump FILE]
    python3 tools/k7_k4_ab.py probe [CHECKOUT_ROOT]
    python3 tools/k7_k4_ab.py time [CHECKOUT_ROOT]
    python3 tools/k7_k4_ab.py ab PARENT_ROOT CHANGE_ROOT
    python3 tools/k7_k4_ab.py ncu [CHECKOUT_ROOT]

`sass` builds the checkout's kernels and counts, from `cuobjdump -sass` of the
library, the instructions of the XEX bodies (`xex_body_kernel*`: K6, K7,
K8), K3 (`ctr_fused_kernel`), K4 (`ghash1_fused_kernel`), K5 and K5-open
(`siv_ctr_kernel*`, `siv_open_kernel`) and K1 (`seal_fused_kernel*`): the
whole function and every loop (a backward branch), by class, and the
instructions a thread (one 32-block row) runs at 16 MiB AES-256 with every
loop multiplied by its trip count.  A loop's trip count comes from its
role, told by its body: the round loop (over 1,000 LOP3) 13 passes; K7's
first design's gray-select loop (one LDS.128 and no LDG, inside the
generator's loop over the row's blocks) nbits = 21 passes an entry, and
that loop over the blocks 32 over its copies of the gray loop (16 with
`unroll 2`; its copy for nbits = 0, with the slot's stores and no inner
loop, none); `level1_row`'s loop (32 LDS.128) 128; level1_mma_warp's loop
over the 16 k-chunks 256 over its MMA count, its loop over two passes 2,
its s1 stores 128 over their count; K4's W1 permutation (8 LDS.128 and
32 stores a transpose) 512 transposes over the block's threads; a loop
with 16-byte loads or stores (a block's rows or W1p to or from shared
memory) its 16-byte accesses a block over the block's threads and its own
count; a loop with 4-byte loads
(`copy_to_smem`) the key planes' 1,920 words over the threads and its
loads; any other loop once.  An inner loop's count multiplies its outer
loop's: a thread runs the function once plus, for each loop, (its passes -
its outer loop's passes) times its static body.  nvcc's `-Xptxas -v` lines
come with them; --dump writes their SASS to FILE.

`probe` builds, from the checkout's csrc/xex_fused.cu and siv_fused.cu, K7
with the row's 32 input loads issued after its offset table is made (the
checkout's kernel) and before it (a copy of its body with the loads moved
up), and K4 in the plane domain (the
rows turned into planes, 4 transposes a row, masked and staged as the B
operand, W1p as it is) and in the word domain (siv_fused.cu's kernel), at
16 MiB (K7 W = 32,768, nbits = 21, AES-256, both directions; K4 W =
32,800), holds each bit for bit against the plain version and the
checkout's wrapper, and times each (CUDA events, three means of 10) beside
the wrapper.

`time` runs, with random keys and data at chip_smoke.py's shapes (CUDA
events, three means of 10 after a warm-up; the profiler's device time, two
means of 10): K7, K8 and K6 both ways at the 16 MiB stream (W = 32,768; K7
nbits = 21), AES-256 and AES-128; K4, K4 on the transposed stream, K5, K5
on the transposed stream and K5-open at the 16 MiB GCM-SIV stream (W =
32,800), AES-256; K3, K1 (seal, open) and K2 (both ways, the v2 seal's
planes) at 16 MiB AES-256; and on the host clock (five warm calls)
ocb_seal/ocb_open, gcm_siv_seal and ctr_bulk of 16 MiB (warm key).  It
prints one JSON line with the checkout, the card's nvidia-smi line, the
times and a SHA-256 of each output: two checkouts that agree bit for bit
print the same digests.

`ab` runs `time` on the parent, the change, the change and the parent, each
in its own process, one after another on the same card.

`ncu` reads, where Nsight Compute is on the machine, the dynamic
instruction count (`smsp__inst_executed.sum`) of K3, K7, K8 and K4 at 16
MiB AES-256, one launch each; where it is not, or cannot profile, it says
so.
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

_KERNELS = ("xex_body_kernel", "ctr_fused_kernel", "ghash1_fused_kernel", "siv_ctr_kernel",
            "siv_open_kernel", "seal_fused_kernel")
_MMA = ("HMMA", "IMMA", "BMMA")
_KEYS = ("total", "lop3", "shf", "other_alu", "lds_sts", "ldg_stg", "branch_loop", "mma",
         "spill_ldl_stl")
ROUND_PASSES = 13   # AES-256: the round loop runs the 13 rounds before the last
NBITS = 21          # K7 at 16 MiB: block indices 1..2^20
KEY_PLANE_WORDS = 15 * 128


def _threads(name: str) -> int:
    """Threads (rows) of a block of each kernel."""
    return 256 if any(k in name for k in ("ghash1", "siv_open", "seal_fused")) else 128


def _classes(body: list[str]) -> dict:
    c = _counts(body)
    by = c["by_op"]
    c["shf"] = by.get("SHF", 0)
    c["mma"] = sum(by.get(op, 0) for op in _MMA)
    c["spill_ldl_stl"] = by.get("LDL", 0) + by.get("STL", 0)
    c["mem"] = _mem_widths(body)
    return c


def _contains(a: list[int], b: list[int]) -> bool:
    return a[0] <= b[0] and b[1] <= a[1] and a != b


def _role(lc: dict, inner: list[dict], name: str, threads: int) -> tuple[str, float]:
    """(role, passes per entry) of one loop, from its body."""
    mem = lc["mem"]
    lds128, ldg32 = mem.get("LDS.128", 0), mem.get("LDG.32", 0)
    stg8 = mem.get("STG.U8", 0) + mem.get("STG.S8", 0)
    if lc["lop3"] > 1000:
        return "round", ROUND_PASSES
    if "GrayOffsets" in name and any(d["role"] == "gray" for d in inner):
        return "gray_blocks", 32 / sum(d["role"] == "gray" for d in inner)
    if "GrayOffsets" in name and lds128 >= 1 and not inner and not mem.get("LDG.128"):
        if mem.get("STS.32"):  # the loop over the blocks as compiled for nbits = 0
            return "gray_blocks_nbits0", 0
        return "gray", NBITS / lds128
    if lds128 == 32 and lc["lop3"] > 100 and not lc["mma"]:
        return "level1_row", 128
    if lds128 == 8 and mem.get("STS.32", 0) >= 32:  # K4's W1 permutation: 512 transposes
        return "w1_transpose", 512 / threads
    if lc["mma"]:
        if any(d["mma"] for d in inner):
            return "level1_mma_pass", 2
        return "level1_mma_k", 256 / lc["mma"]
    if stg8:
        return "s1_store", 128 / stg8
    wide = mem.get("LDG.128", 0) + mem.get("STG.128", 0)
    if wide:
        rows = 128 if mem.get("STS.128") else threads  # W1p's 128 rows or the block's
        return "rows_16B", rows * 32 / threads / wide
    if ldg32:
        return "copy_to_smem", KEY_PLANE_WORDS / threads / ldg32
    return "other", 1


def function_counts(func: str, name: str) -> dict:
    code = _code(func)
    fn = _classes([t for _, t in code])
    found = []
    for d in loops(func):  # innermost first
        lo, hi = d["span"]
        found.append({"span": d["span"], **_classes([t for a, t in code if lo <= a <= hi])})
    threads = _threads(name)
    for d in found:
        inner = [e for e in found if _contains(d["span"], e["span"])]
        d["role"], d["passes_per_entry"] = _role(d, inner, name, threads)
    per_row = {k: fn[k] for k in _KEYS}
    for d in sorted(found, key=lambda e: -(e["span"][1] - e["span"][0])):  # outermost first
        outer = [e for e in found if _contains(e["span"], d["span"])]
        parent = min(outer, key=lambda e: e["span"][1] - e["span"][0]) if outer else None
        up = parent["passes"] if parent else 1
        d["passes"] = up * d["passes_per_entry"]
        for k in _KEYS:
            per_row[k] += (d["passes"] - up) * d[k]
    return {"function": fn, "loops": found,
            "per_row_aes256": {k: round(v) for k, v in per_row.items()}}


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
        lib = Path(shutil.copy(_build.build(), Path(tempfile.gettempdir(), "k7_k4_sass.so")))
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs = {}
    for func in re.split(r"\n\s*Function : ", text):
        name = func.split("\n", 1)[0].strip()
        if any(k in name for k in _KERNELS):
            funcs[name] = func
    names = _demangle(list(funcs))
    found = {names[n]: function_counts(f, names[n]) for n, f in funcs.items()}
    if dump:
        dump.parent.mkdir(parents=True, exist_ok=True)
        dump.write_text("\n".join(f"Function : {names[n]}\n{f}" for n, f in funcs.items()))
    ptxas, cur = [], None
    for ln in _build.build_info.log.splitlines():
        if "Function properties for" in ln:
            cur = ln.split("for", 1)[1].strip()
        elif cur and any(k in cur for k in _KERNELS) and ("Used" in ln or "spill" in ln):
            ptxas.append(f"{names.get(cur, cur)}: {ln.strip()}")
    return {"checkout": str(root), "library": lib.name, "kernels": found, "ptxas": ptxas}


# -- probe --------------------------------------------------------------------

PROBE_SRC = r"""
#include "xex_fused.cu"
#include "siv_fused.cu"

namespace {

// K7 with its row's 32 input loads issued before its table is made, so that
// their latency overlaps it (the checkout's kernel issues them after)
template <bool DECRYPT>
__global__ void __launch_bounds__(kRows)
k7_early_kernel(GrayOffsets gen, const uint32_t* __restrict__ kp,
                const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int rounds, int w) {
  extern __shared__ uint32_t smem[];
  uint32_t* kps = smem;
  uint32_t* slots = kps + uaes::kMaxKeyPlaneWords;
  const int w0 = blockIdx.x * kRows;
  const int row = w0 + threadIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(in) + static_cast<size_t>(row) * 32;
  uint4 v[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) v[j] = row < w ? __ldg(src + j) : make_uint4(0u, 0u, 0u, 0u);
  uaes::copy_to_smem(kp, kps, (rounds + 1) * 128);
  gen.stage(slots, w0, w);
  __syncthreads();
  uint32_t* slot = slots + threadIdx.x * uaes::kStageStride;
  uint32_t a[4][32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    a[0][j] = v[j].x ^ slot[4 * j];
    a[1][j] = v[j].y ^ slot[4 * j + 1];
    a[2][j] = v[j].z ^ slot[4 * j + 2];
    a[3][j] = v[j].w ^ slot[4 * j + 3];
  }
  uint32_t s[8][16];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uaes::transpose32(a[k]);
#pragma unroll
    for (int r = 0; r < 32; ++r) s[r % 8][4 * k + r / 8] = a[k][r];
  }
  if (DECRYPT) {
    uaes::decrypt_state(s, kps, rounds);
  } else {
    uaes::encrypt_state(s, kps, rounds);
  }
  uaes::xor_planes_into_row(s, slot);
  __syncthreads();
  uaes::stage_rows_out(slots, out, w0, kRows, w);
}

// K4 in the plane domain: the rows staged as they are, each turned into
// planes, masked by ghm and staged as the B operand; W1p as it is
__global__ void __launch_bounds__(kGhashRows, 1)
k4_planes_kernel(const uint32_t* __restrict__ ghmask, const uint32_t* __restrict__ w1p,
                 const uint32_t* __restrict__ x, int8_t* __restrict__ s1, int w) {
  extern __shared__ uint32_t smem[];
  uint32_t* w1s = smem;
  uint32_t* rows = w1s + 128 * uaes::kL1Stride;
  const int w0 = blockIdx.x * kGhashRows;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
#pragma unroll
  for (int n = 0; n < 32; ++n) {
    const int i = n * kGhashRows + threadIdx.x;
    const int r = i >> 5, j = i & 31, gw = w0 + r;
    const uint4 v = gw < w ? __ldg(x4 + static_cast<size_t>(gw) * 32 + j)
                           : make_uint4(0u, 0u, 0u, 0u);
    uint32_t* d = rows + r * uaes::kStageStride + 4 * j;
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  }
#pragma unroll
  for (int n = 0; n < 128 * 32 / kGhashRows; ++n) {
    const int i = n * kGhashRows + threadIdx.x;
    reinterpret_cast<uint4*>(w1s + (i >> 5) * uaes::kL1Stride)[i & 31] =
        __ldg(reinterpret_cast<const uint4*>(w1p) + i);
  }
  __syncthreads();
  const int row = w0 + threadIdx.x;
  const uint32_t ghm = row < w ? ghmask[row] : 0u;
  uint32_t s[8][16];
  uaes::row_to_planes(s, rows + threadIdx.x * uaes::kStageStride);
  __syncthreads();
  uaes::stage_level1_row(s, ghm, rows + threadIdx.x * uaes::kL1Stride);
  __syncwarp();
  const int first = threadIdx.x & ~31;
  uaes::level1_mma_warp(w1s, rows + first * uaes::kL1Stride, s1, w0 + first, w);
}

}  // namespace

extern "C" int probe_k7(const uint32_t* kp, const uint32_t* d0l, const uint32_t* lbl,
                        const uint32_t* pt, uint32_t* out, int nbits, int rounds, int w,
                        int decrypt, int early, cudaStream_t stream) {
  const GrayOffsets gen{d0l, lbl, nbits};
  if (!early) return launch_xex(gen, kp, pt, out, rounds, w, decrypt, stream);
  const int smem = (uaes::kMaxKeyPlaneWords + kRows * uaes::kStageStride) * 4;
  auto kernel = decrypt ? k7_early_kernel<true> : k7_early_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(w + kRows - 1) / kRows, kRows, smem, stream>>>(gen, kp, pt, out, rounds, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_k4(const uint32_t* ghmask, const uint32_t* w1p, const uint32_t* x,
                        int8_t* s1, int w, int words, cudaStream_t stream) {
  if (words)
    return launch(ghash1_fused_kernel, kGhashRows, kGhashSmemWords, w, stream, ghmask, w1p, x,
                  s1, w);
  return launch(k4_planes_kernel, kGhashRows, kGhashSmemWords, w, stream, ghmask, w1p, x, s1, w);
}
"""

XEX_ROWS = 32_768  # W of K6/K7/K8 at 16 MiB
SEED = 31


def _build_probe(root: Path):
    from micro_aes_tpu_torch.ops import _build

    csrc = root.resolve() / "micro_aes_tpu_torch" / "csrc"
    with tempfile.TemporaryDirectory() as tmp:
        src, so = Path(tmp, "probe.cu"), Path(tmp, "libprobe.so")
        src.write_text(PROBE_SRC)
        built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-shared",
                                "-o", str(so), str(src)], capture_output=True, text=True)
        if built.returncode:
            return None, built.stdout + built.stderr
        lib = ctypes.CDLL(str(so))
    ptxas, cur = [], None
    for ln in (built.stdout + built.stderr).splitlines():
        if "Function properties for" in ln:
            cur = ln.split("for", 1)[1].strip()
        elif cur and ("Used" in ln or "spill" in ln) and any(
                k in cur for k in ("k7_early", "GrayOffsets", "k4_planes", "ghash1")):
            ptxas.append(f"{cur}: {ln.strip()}")
    lib.probe_k7.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.probe_k4.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    return lib, ptxas


def probe(root: Path) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, str(root.resolve()))
    from micro_aes_tpu_torch.modes import seal, siv_seal
    from micro_aes_tpu_torch.modes.seal import position_mask
    from micro_aes_tpu_torch.ops import siv_kernels as sk
    from micro_aes_tpu_torch.ops import xex_kernels as xk

    lib, ptxas = _build_probe(root)
    if lib is None:
        return {"error": ptxas}
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    def words(*shape):
        return torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint32)
                                .view(np.int32)).to(dev)

    stream = torch.cuda.current_stream(dev).cuda_stream
    ms, same = {}, {}
    # K7
    w, nbits = XEX_ROWS, NBITS
    kp, _ = seal.gcm_key_setup(rng.integers(0, 256, 32, dtype=np.uint8).tobytes(), device=dev)
    kpf, rounds = kp.reshape(-1, 1), kp.shape[0] - 1
    x, d0l, lbl = words(w, 128), words(1, 128), words(nbits, 128)
    out = torch.empty_like(x)

    def k7(early, decrypt):
        err = lib.probe_k7(kpf.data_ptr(), d0l.data_ptr(), lbl.data_ptr(), x.data_ptr(),
                           out.data_ptr(), nbits, rounds, w, int(decrypt), int(early), stream)
        if err:
            raise RuntimeError(f"probe_k7: launch error {err}")
        return out

    for decrypt in (False, True):
        sfx = "_dec" if decrypt else ""
        want = xk.ocb_fused_plain(kpf, d0l, lbl, x, nbits, decrypt)
        mine = xk.ocb_fused(kpf, d0l, lbl, x, nbits, decrypt)
        same["checkout_k7" + sfx] = bool(torch.equal(mine, want))
        for early in (True, False):
            name = f"k7_loads_{'before' if early else 'after'}_table{sfx}"
            same[name] = bool(torch.equal(k7(early, decrypt).clone(), want))
            ms[name] = [round(_cuda_ms(lambda e=early: k7(e, decrypt)), 4) for _ in range(3)]
        ms["checkout_k7" + sfx] = [
            round(_cuda_ms(lambda: xk.ocb_fused(kpf, d0l, lbl, x, nbits, decrypt)), 4)
            for _ in range(3)]
    # K4
    n = 1 << 20
    ws = siv_seal._stream_words(n)
    front = 32 * ws - (n + 1)
    ghm = position_mask(ws, front, 32 * ws, dev)
    _, _, tables = siv_seal._siv_key_setup(rng.integers(0, 256, 32, dtype=np.uint8).tobytes(),
                                           bytes(12), dev)
    w1p, xs = tables[5], words(ws, 128)
    s1 = torch.empty((128, ws), dtype=torch.int8, device=dev)

    def k4(form):
        err = lib.probe_k4(ghm.data_ptr(), w1p.data_ptr(), xs.data_ptr(), s1.data_ptr(), ws,
                           int(form == "words"), stream)
        if err:
            raise RuntimeError(f"probe_k4: launch error {err}")
        return s1

    want = sk.ghash1_fused_plain(ghm, w1p, xs)
    same["checkout_k4"] = bool(torch.equal(sk.ghash1_fused(ghm, w1p, xs), want))
    for form in ("planes", "words"):
        same[f"k4_{form}"] = bool(torch.equal(k4(form).clone(), want))
        ms[f"k4_{form}"] = [round(_cuda_ms(lambda f=form: k4(f)), 4) for _ in range(3)]
    ms["checkout_k4"] = [round(_cuda_ms(lambda: sk.ghash1_fused(ghm, w1p, xs)), 4)
                         for _ in range(3)]
    return {"checkout": str(root), "nvidia_smi": _smi(), "ms": ms, "equal_to_plain": same,
            "ptxas": ptxas}


# -- time ---------------------------------------------------------------------

def _kernels(root: Path, dev, rng) -> dict:
    """name -> a call of one kernel at chip_smoke.py's 16 MiB shapes."""
    import numpy as np
    import torch

    sys.path.insert(0, str(root.resolve()))
    from micro_aes_tpu_torch.modes import seal, siv_seal
    from micro_aes_tpu_torch.modes.seal import position_mask
    from micro_aes_tpu_torch.ops import siv_kernels as sk
    from micro_aes_tpu_torch.ops import xex_kernels as xk
    from micro_aes_tpu_torch.ops.cipher_kernel import cipher_planes
    from micro_aes_tpu_torch.ops.counter import j0_planes, lohi_words
    from micro_aes_tpu_torch.ops.seal_kernels import ctr_fused, seal_fused

    def words(*shape):
        return torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint32)
                                .view(np.int32)).to(dev)

    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    kernels = {}
    w, nbits = XEX_ROWS, NBITS
    for klen in (32, 16):
        kp, _ = seal.gcm_key_setup(rand(klen), device=dev)
        kpf, aes = kp.reshape(-1, 1), 8 * klen
        x, y = words(w, 128), words(w, 128)
        d0l, lbl = words(1, 128), words(nbits, 128)
        for decrypt in (False, True):
            sfx = f"_aes{aes}{'_dec' if decrypt else ''}"
            kernels["k7" + sfx] = lambda a=(kpf, d0l, lbl, x, nbits, decrypt): xk.ocb_fused(*a)
            kernels["k8" + sfx] = lambda a=(kpf, y, x, decrypt): xk.ctrw_fused(*a)
            kernels["k6" + sfx] = lambda a=(kpf, y, x, decrypt): xk.xex_fused(*a)
    n = 1 << 20
    ws = siv_seal._stream_words(n)
    front = 32 * ws - (n + 1)
    ghm_seal = position_mask(ws, front, 32 * ws, dev)
    ghm_open = position_mask(ws, front, 32 * ws - 1, dev)
    _, kp, tables = siv_seal._siv_key_setup(rand(32), rand(12), dev)
    kpf, w1p = kp.reshape(-1, 1), tables[5]
    basew = siv_seal._siv_basew(words(4), front)
    xs = words(ws, 128)
    xs_t = xs.T.contiguous()
    kernels["k4"] = lambda: sk.ghash1_fused(ghm_seal, w1p, xs)
    kernels["k4t"] = lambda: sk.ghash1_fused_t(ghm_seal, w1p, xs_t)
    kernels["k5_aes256"] = lambda: sk.siv_ctrw_fused(kpf, basew, xs)
    kernels["k5t_aes256"] = lambda: sk.siv_ctrw_fused_t(kpf, basew, xs_t)
    kernels["k5open_aes256"] = lambda: sk.siv_open_fused(kpf, basew, ghm_open, w1p, xs)
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
    planes = words(8, 16, seal.stream_words(n + 2))  # K2 as the v2 seal
    for decrypt in (False, True):
        kernels[f"k2_aes256{'_dec' if decrypt else ''}"] = \
            lambda d=decrypt: cipher_planes(kp, planes, d)
    return kernels


def timed(root: Path) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, str(root.resolve()))
    from micro_aes_tpu_torch.modes import ocb_bulk, seal, siv_seal

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    ms, dev_ms, sha = {}, {}, {}
    for name, fn in _kernels(root, dev, rng).items():
        sha[name] = _digest(fn())
        ms[name] = [round(_cuda_ms(fn), 4) for _ in range(3)]
        dev_ms[name] = [round(_device_ms(fn), 4) for _ in range(2)]

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

    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    data = rand(16 << 20)
    okey, ononce, aad = rand(16), rand(12), rand(16)
    oblob = ocb_bulk.ocb_seal(okey, ononce, aad, data, device=dev)
    skey, snonce = rand(32), rand(12)
    ckey, cnonce = rand(32), rand(12)
    requests = {
        "ocb_seal_16MiB": lambda: ocb_bulk.ocb_seal(okey, ononce, aad, data, device=dev),
        "ocb_open_16MiB": lambda: ocb_bulk.ocb_open(okey, ononce, aad, oblob, device=dev),
        "gcm_siv_seal_16MiB": lambda: siv_seal.gcm_siv_seal(skey, snonce, data, device=dev),
        "ctr_bulk_16MiB": lambda: seal.ctr_bulk(ckey, cnonce, data, device=dev),
    }
    secs = {}
    for name, fn in requests.items():
        sha[name] = _digest(fn())
        secs[name] = host_s(fn)
    return {"checkout": str(root), "nvidia_smi": _smi(), "kernel_ms": ms, "device_ms": dev_ms,
            "host_s": secs, "sha256": sha}


# -- ncu ----------------------------------------------------------------------

_NCU_KERNELS = ("k3_aes256", "k7_aes256", "k8_aes256", "k4")


def once(root: Path) -> dict:
    """One launch of each of K3, K7, K8 and K4 at 16 MiB (what `ncu` profiles)."""
    import numpy as np
    import torch

    dev = torch.device("cuda", 0)
    kernels = _kernels(root, dev, np.random.default_rng(SEED))
    for name in _NCU_KERNELS:
        kernels[name]()
    torch.cuda.synchronize()
    return {"launched": list(_NCU_KERNELS)}


def ncu(root: Path) -> dict:
    tool = shutil.which("ncu") or next((str(p) for p in Path("/usr/local/cuda/bin").glob("ncu")
                                        if p.exists()), None)
    if tool is None:
        return {"ncu": None, "note": "Nsight Compute (ncu) is not on this machine"}
    cmd = [tool, "--csv", "--metrics", "smsp__inst_executed.sum", "-k",
           "regex:ctr_fused_kernel|xex_body_kernel|ghash1_fused_kernel",
           sys.executable, str(HERE), "once", str(root)]
    try:
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except subprocess.TimeoutExpired:
        return {"ncu": tool, "note": "ncu did not finish in 600 s"}
    rows = [ln for ln in run.stdout.splitlines() if "smsp__inst_executed" in ln]
    out = {"ncu": tool, "returncode": run.returncode, "rows": rows}
    if not rows:
        out["stdout_tail"], out["stderr_tail"] = run.stdout[-2000:], run.stderr[-2000:]
    return out


def main() -> int:
    args = sys.argv[1:]
    if not args or args[0] not in ("sass", "probe", "time", "ab", "ncu", "once"):
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
    if args[0] == "ncu":
        print(json.dumps(ncu(root)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("k7_k4_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    fn = {"probe": probe, "time": timed, "once": once}[args[0]]
    print(json.dumps(fn(root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
