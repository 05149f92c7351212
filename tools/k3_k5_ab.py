#!/usr/bin/env python3
"""K3 (ctr_fused.cu, the CTR keystream of `ctr_bulk`) and K5 (siv_fused.cu,
the CTR pass of `gcm_siv_seal`) of micro_aes_tpu_torch, and K5-open, which
shares K5's counters: their design steps as forms of one micro-kernel, on
one NVIDIA GPU.  Times of two checkouts side by side come from
`tools/k7_k4_ab.py ab`, which this tool's helpers come from.

    python3 tools/k3_k5_ab.py sass [CHECKOUT_ROOT]
    python3 tools/k3_k5_ab.py probe [CHECKOUT_ROOT]

`sass` counts, as `tools/k7_k4_ab.py sass` does (the instructions a thread,
one 32-block row, runs at 16 MiB AES-256 with every loop multiplied by its
trip count), the checkout's K3, K5, K5-open and K1 and every form of the
probe below, with nvcc's `-Xptxas -v` lines, and the SASS instructions of
one `transpose32` (a kernel that loads 32 words, transposes them and stores
them, less the same kernel without the transpose).

`probe` builds, from the checkout's csrc/ctr_fused.cu and siv_fused.cu, a
micro-kernel of 128 rows a block in five forms: (0) `planes`: the rows
staged before the cipher (129 words apart) and the keystream XORed in the
plane domain, 8 transposes a row, as the first design of K3 and K5;
(1) `words_sync`: the rows staged before the cipher, 132 words apart, the
keystream turned into words in place and XORed on with 16-byte shared
accesses; (2) `words_async`: (1) with the rows copied by cp.async, 16 bytes
a thread, issued first and waited on only after the cipher; (3)
`words_bulk`: (1) with one cp.async.bulk (TMA) of 512 B a row on an
mbarrier, issued by the block's first thread and waited on after the
cipher (aes_bitslice.cuh ctr_xor_body); (4) `words_bulk_out`: (3) with the
rows stored by one bulk copy a row too.  Each form runs with GCM's
counters (K3) and with GCM-SIV's in the first design's word domain (4
transposes a row, `siv_words`) and in the plane domain (the base turned
into planes once a block, a 27-bit bitsliced add a row, `siv_planes`);
K5-open's body runs with both GCM-SIV counter forms.  Every form is held
bit for bit against the plain version at 16 MiB AES-256 (K3 W = 32,776,
K5 W = 32,800) and at W = 1, 127, 128, 129 and 300 with GCM-SIV bases of
random lanes, a word 0 that wraps inside a row and across rows, and lanes
where basew[4j] + j itself wraps for some j, and is timed at 16 MiB (CUDA
events, three means of 10; the profiler's device time, two means of 10)
beside the checkout's wrappers.
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

from k15_k1_ab import _cuda_ms, _device_ms, _smi  # noqa: E402
from k7_k4_ab import _demangle, function_counts  # noqa: E402
from k7_k4_ab import sass as k7_k4_sass  # noqa: E402
from spread_ab import _code  # noqa: E402

PROBE_SRC = r"""
#include "ctr_fused.cu"
#include "siv_fused.cu"

namespace {

constexpr int kP = 128;  // rows (threads) a block, as K3 and K5

// The first design's GCM-SIV counters: each row's 32 counter blocks in the
// word domain, turned into planes, 4 transposes a row
struct WordSivCounters {
  const uint32_t* basew;
  __device__ __forceinline__ void stage(uint32_t* cs) const { uaes::copy_to_smem(basew, cs, 128); }
  __device__ __forceinline__ void planes(uint32_t (&s)[8][16], const uint32_t* cs, int row,
                                         bool) const {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t a[32];
#pragma unroll
      for (int j = 0; j < 32; ++j)
        a[j] = cs[4 * j + k] + (k == 0 ? 32u * static_cast<uint32_t>(row) + j : 0u);
      uaes::transpose32(a);
#pragma unroll
      for (int r = 0; r < 32; ++r) s[r % 8][4 * k + r / 8] = a[r];
    }
  }
};

enum { kPlanes = 0, kWordsSync = 1, kWordsAsync = 2, kWordsBulk = 3, kWordsBulkOut = 4 };

// rows w0.. into the stage area (kL1Stride apart) as 16-byte cp.async
// copies, coalesced, one commit group; waited on by cp.async.wait_all
__device__ __forceinline__ void stage_rows_async(const uint32_t* __restrict__ src,
                                                 uint32_t* stage, int w0, int w) {
  const uint4* src4 = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int n = 0; n < 32; ++n) {
    const int i = n * kP + threadIdx.x, r = i >> 5, c4 = i & 31;
    if (w0 + r < w)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                   ::"r"(uaes::smem_u32(stage + r * uaes::kL1Stride + 4 * c4)),
                   "l"(src4 + static_cast<size_t>(w0 + r) * 32 + c4) : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int FORM, class Ctr>
__global__ void __launch_bounds__(kP)
probe_ctr_kernel(Ctr ctr, const uint32_t* __restrict__ kp, const uint32_t* __restrict__ in,
                 uint32_t* __restrict__ out, int rounds, int w) {
  extern __shared__ uint32_t smem[];
  uint32_t* kps = smem;
  uint32_t* cs = kps + uaes::kMaxKeyPlaneWords;
  uint32_t* stage = cs + 128;
  uint64_t* bar = reinterpret_cast<uint64_t*>(stage + kP * uaes::kL1Stride);
  const int w0 = blockIdx.x * kP;
  const bool bulk = FORM == kWordsBulk || FORM == kWordsBulkOut;
  if (FORM == kWordsAsync) stage_rows_async(in, stage, w0, w);
  if (bulk && threadIdx.x == 0) uaes::stage_rows_bulk(in, stage, bar, w0, min(kP, w - w0));
  uaes::copy_to_smem(kp, kps, (rounds + 1) * 128);
  ctr.stage(cs);
  if (FORM == kPlanes) uaes::stage_rows_in(in, stage, w0, kP, w);
  if (FORM == kWordsSync) {
    const uint4* in4 = reinterpret_cast<const uint4*>(in);
#pragma unroll
    for (int n = 0; n < 32; ++n) {
      const int i = n * kP + threadIdx.x, r = i >> 5, c4 = i & 31;
      if (w0 + r < w)
        reinterpret_cast<uint4*>(stage + r * uaes::kL1Stride)[c4] =
            __ldg(in4 + static_cast<size_t>(w0 + r) * 32 + c4);
    }
  }
  __syncthreads();

  const int row = w0 + threadIdx.x;
  const bool live = row < w;
  uint32_t s[8][16];
  ctr.planes(s, cs, row, live);
  uaes::encrypt_state(s, kps, rounds);
  if (FORM == kPlanes) {
    uaes::xor_stream_row<false, false>(s, stage + threadIdx.x * uaes::kStageStride);
    __syncthreads();
    uaes::stage_rows_out(stage, out, w0, kP, w);
    return;
  }
  uaes::planes_to_words(s);
  if (FORM == kWordsAsync) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
  }
  if (bulk) uaes::wait_rows_bulk(bar);
  if (live) uaes::xor_words_into_row(s, stage + threadIdx.x * uaes::kL1Stride);
  if (FORM == kWordsBulkOut) {  // one bulk store a row, by the first thread
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int r = 0; r < min(kP, w - w0); ++r)
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                     ::"l"(out + static_cast<size_t>(w0 + r) * 128),
                     "r"(uaes::smem_u32(stage + r * uaes::kL1Stride)), "r"(512) : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
    return;
  }
  __syncthreads();
  uaes::stage_rows_out_wide<kP>(stage, out, w0, w);
}

template <int FORM, class Ctr>
int launch_form(Ctr ctr, const uint32_t* kp, const uint32_t* in, uint32_t* out, int rounds, int w,
                cudaStream_t stream) {
  const int smem = (uaes::ctr_xor_smem_words(kP) + 2) * 4;
  auto kernel = probe_ctr_kernel<FORM, Ctr>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(w + kP - 1) / kP, kP, smem, stream>>>(ctr, kp, in, out, rounds, w);
  return static_cast<int>(cudaGetLastError());
}

template <class Ctr>
int by_form(int form, Ctr ctr, const uint32_t* kp, const uint32_t* in, uint32_t* out, int rounds,
            int w, cudaStream_t stream) {
  switch (form) {
    case kPlanes: return launch_form<kPlanes>(ctr, kp, in, out, rounds, w, stream);
    case kWordsSync: return launch_form<kWordsSync>(ctr, kp, in, out, rounds, w, stream);
    case kWordsAsync: return launch_form<kWordsAsync>(ctr, kp, in, out, rounds, w, stream);
    case kWordsBulk: return launch_form<kWordsBulk>(ctr, kp, in, out, rounds, w, stream);
    default: return launch_form<kWordsBulkOut>(ctr, kp, in, out, rounds, w, stream);
  }
}

// K5-open's body with either form of GCM-SIV's counters
template <class Ctr>
__global__ void __launch_bounds__(kOpenRows, 1)
probe_siv_open_kernel(Ctr ctr, const uint32_t* __restrict__ kp, const uint32_t* __restrict__ ghmask,
                      const uint32_t* __restrict__ w1p, const uint32_t* __restrict__ in,
                      uint32_t* __restrict__ out, int8_t* __restrict__ s1, int rounds, int w) {
  extern __shared__ uint32_t smem[];
  uaes::ctr_level1_body<kOpenRows, false>(smem, ctr, kp, ghmask, w1p, in, out, s1, rounds, w);
}

// one transpose32 between a load and a store of 32 words, and the same
// without it: the difference of their SASS is one transpose's
__global__ void t32_with(const uint32_t* __restrict__ in, uint32_t* __restrict__ out) {
  uint32_t a[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) a[j] = in[threadIdx.x * 32 + j];
  uaes::transpose32(a);
#pragma unroll
  for (int j = 0; j < 32; ++j) out[threadIdx.x * 32 + j] = a[j];
}

__global__ void t32_without(const uint32_t* __restrict__ in, uint32_t* __restrict__ out) {
  uint32_t a[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) a[j] = in[threadIdx.x * 32 + j];
#pragma unroll
  for (int j = 0; j < 32; ++j) out[threadIdx.x * 32 + j] = a[j];
}

}  // namespace

// ctr: 0 GCM (a = j0c, lohi), 1 GCM-SIV in the word domain, 2 in the plane
// domain (a = basew)
extern "C" int probe_ctr(int form, int ctr, const uint32_t* kp, const uint32_t* a,
                         const uint32_t* lohi, const uint32_t* in, uint32_t* out, int rounds,
                         int w, cudaStream_t stream) {
  if (ctr == 0) return by_form(form, uaes::GcmCounters{a, lohi, w}, kp, in, out, rounds, w, stream);
  if (ctr == 1) return by_form(form, WordSivCounters{a}, kp, in, out, rounds, w, stream);
  return by_form(form, SivCounters{a}, kp, in, out, rounds, w, stream);
}

extern "C" int probe_open(int ctr, const uint32_t* kp, const uint32_t* basew,
                          const uint32_t* ghmask, const uint32_t* w1p, const uint32_t* in,
                          uint32_t* out, int8_t* s1, int rounds, int w, cudaStream_t stream) {
  const int words = uaes::ctr_level1_smem_words(kOpenRows);
  if (ctr == 1)
    return launch(probe_siv_open_kernel<WordSivCounters>, kOpenRows, words, w, stream,
                  WordSivCounters{basew}, kp, ghmask, w1p, in, out, s1, rounds, w);
  return launch(probe_siv_open_kernel<SivCounters>, kOpenRows, words, w, stream,
                SivCounters{basew}, kp, ghmask, w1p, in, out, s1, rounds, w);
}
"""

FORMS = ("planes", "words_sync", "words_async", "words_bulk", "words_bulk_out")
CTRS = ("gcm", "siv_words", "siv_planes")
EDGE_ROWS = (1, 127, 128, 129, 300)
SEED = 37


def _build_probe(root: Path):
    """The probe's library, built once per source (sass and probe share it
    within a machine's temporary directory), and nvcc's log."""
    from micro_aes_tpu_torch.ops import _build

    csrc = root.resolve() / "micro_aes_tpu_torch" / "csrc"
    h = hashlib.sha256(PROBE_SRC.encode())
    for path in sorted(csrc.glob("*.cu*")):
        h.update(path.read_bytes())
    tmp = Path(tempfile.gettempdir(), f"k3_k5_probe_{h.hexdigest()[:16]}")
    src, so, log_file = tmp / "probe.cu", tmp / "libprobe.so", tmp / "nvcc.log"
    if so.exists():
        return so, log_file.read_text()
    tmp.mkdir(parents=True, exist_ok=True)
    src.write_text(PROBE_SRC)
    built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-shared",
                            "-o", str(so), str(src)], capture_output=True, text=True)
    log = built.stdout + built.stderr
    if built.returncode:
        so.unlink(missing_ok=True)
        return None, log
    log_file.write_text(log)
    return so, log


def _ptxas(log: str, keys: tuple[str, ...]) -> list[str]:
    out, cur = [], None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            cur = ln.split("for", 1)[1].strip()
        elif cur and any(k in cur for k in keys) and ("Used" in ln or "spill" in ln):
            out.append(f"{cur}: {ln.strip()}")
    return out


def sass(root: Path) -> dict:
    sys.path.insert(0, str(root.resolve()))
    own = k7_k4_sass(root, None)
    keep = ("ctr_fused_kernel", "siv_ctr_kernel", "siv_open_kernel", "seal_fused_kernel")
    checkout = {n: d["per_row_aes256"] for n, d in own["kernels"].items()
                if any(k in n for k in keep)}
    ptxas = [ln for ln in own["ptxas"] if any(k in ln for k in keep)]
    so, log = _build_probe(root)
    if so is None:
        return {"checkout": checkout, "ptxas": ptxas, "probe_error": log}
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    funcs = {}
    for func in re.split(r"\n\s*Function : ", text):
        name = func.split("\n", 1)[0].strip()
        if any(k in name for k in ("probe_ctr_kernel", "probe_siv_open_kernel", "t32_")):
            funcs[name] = func
    names = _demangle(list(funcs))
    probe, t32 = {}, {}
    for n, f in funcs.items():
        if "t32_" in names[n]:
            t32["with" if "t32_with" in names[n] else "without"] = len(_code(f))
        else:
            probe[names[n]] = function_counts(f, names[n])["per_row_aes256"]
    return {"checkout_root": str(root), "checkout": checkout, "ptxas": ptxas, "probe": probe,
            "probe_ptxas": _ptxas(log, ("probe_",)),
            "transpose32_sass": t32.get("with", 0) - t32.get("without", 0)}


def probe(root: Path) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, str(root.resolve()))
    from micro_aes_tpu_torch.modes import seal, siv_seal
    from micro_aes_tpu_torch.modes.seal import position_mask
    from micro_aes_tpu_torch.ops import siv_kernels as sk
    from micro_aes_tpu_torch.ops.counter import j0_planes, lohi_words
    from micro_aes_tpu_torch.ops.seal_kernels import ctr_fused, ctr_fused_plain

    so, log = _build_probe(root)
    if so is None:
        return {"error": log}
    lib = ctypes.CDLL(str(so))
    lib.probe_ctr.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + \
        [ctypes.c_void_p]
    lib.probe_open.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + \
        [ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def words(*shape):
        return torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint32)
                                .view(np.int32)).to(dev)

    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    def run_ctr(form, ctr, kpf, a, lohi, x):
        out = torch.empty_like(x)
        err = lib.probe_ctr(FORMS.index(form), CTRS.index(ctr), kpf.data_ptr(), a.data_ptr(),
                            0 if lohi is None else lohi.data_ptr(), x.data_ptr(),
                            out.data_ptr(), kpf.shape[0] // 128 - 1, x.shape[0], stream)
        if err:
            raise RuntimeError(f"probe_ctr {form} {ctr}: launch error {err}")
        return out

    def run_open(ctr, kpf, basew, ghm, w1p, x):
        out = torch.empty_like(x)
        s1 = torch.empty((128, x.shape[0]), dtype=torch.int8, device=dev)
        err = lib.probe_open(CTRS.index(ctr), kpf.data_ptr(), basew.data_ptr(), ghm.data_ptr(),
                             w1p.data_ptr(), x.data_ptr(), out.data_ptr(), s1.data_ptr(),
                             kpf.shape[0] // 128 - 1, x.shape[0], stream)
        if err:
            raise RuntimeError(f"probe_open {ctr}: launch error {err}")
        return out, s1

    def timed(fn):
        return {"cuda_ms": [round(_cuda_ms(fn), 4) for _ in range(3)],
                "device_ms": [round(_device_ms(fn), 4) for _ in range(2)]}

    ms, same = {}, {}
    n = 1 << 20
    # K3 at 16 MiB AES-256, as ctr_bulk
    kp, _ = seal.gcm_key_setup(rand(32), device=dev)
    kpf = kp.reshape(-1, 1)
    w_ctr = seal.stream_words(n + 1)
    j0 = seal._j0_block(rand(12), dev)
    j0c, lohi = j0_planes(j0), lohi_words(j0, w_ctr, -1)
    x = words(w_ctr, 128)
    want = ctr_fused_plain(kpf, j0c, lohi, x)
    same["checkout_k3"] = bool(torch.equal(ctr_fused(kpf, j0c, lohi, x), want))
    ms["checkout_k3"] = timed(lambda: ctr_fused(kpf, j0c, lohi, x))
    for form in FORMS:
        name = f"k3_{form}"
        same[name] = bool(torch.equal(run_ctr(form, "gcm", kpf, j0c, lohi, x), want))
        ms[name] = timed(lambda f=form: run_ctr(f, "gcm", kpf, j0c, lohi, x))
    # K5 and K5-open at the 16 MiB GCM-SIV stream, AES-256
    ws = siv_seal._stream_words(n)
    front = 32 * ws - (n + 1)
    ghm = position_mask(ws, front, 32 * ws - 1, dev)
    _, skp, tables = siv_seal._siv_key_setup(rand(32), rand(12), dev)
    skpf, w1p = skp.reshape(-1, 1), tables[5]
    basew = siv_seal._siv_basew(words(4), front)
    xs = words(ws, 128)
    want = sk.siv_ctrw_fused_plain(skpf, basew, xs)
    same["checkout_k5"] = bool(torch.equal(sk.siv_ctrw_fused(skpf, basew, xs), want))
    ms["checkout_k5"] = timed(lambda: sk.siv_ctrw_fused(skpf, basew, xs))
    for ctr in ("siv_words", "siv_planes"):
        for form in FORMS:
            name = f"k5_{form}_{ctr}"
            same[name] = bool(torch.equal(run_ctr(form, ctr, skpf, basew, None, xs), want))
            ms[name] = timed(lambda f=form, c=ctr: run_ctr(f, c, skpf, basew, None, xs))
    want_o = sk.siv_open_fused_plain(skpf, basew, ghm, w1p, xs)
    got_o = sk.siv_open_fused(skpf, basew, ghm, w1p, xs)
    same["checkout_k5open"] = bool(torch.equal(got_o[0], want_o[0])
                                   and torch.equal(got_o[1], want_o[1]))
    ms["checkout_k5open"] = timed(lambda: sk.siv_open_fused(skpf, basew, ghm, w1p, xs))
    for ctr in ("siv_words", "siv_planes"):
        got_o = run_open(ctr, skpf, basew, ghm, w1p, xs)
        same[f"k5open_{ctr}"] = bool(torch.equal(got_o[0], want_o[0])
                                     and torch.equal(got_o[1], want_o[1]))
        ms[f"k5open_{ctr}"] = timed(lambda c=ctr: run_open(c, skpf, basew, ghm, w1p, xs))
    # the edges: a partly full last block, and GCM-SIV bases of random lanes,
    # a word 0 that wraps inside a row and across rows, and lanes where
    # basew[4j] + j wraps for some j
    edges = {}
    for we in EDGE_ROWS:
        xe = words(we, 128)
        le = lohi_words(j0, we, -1)
        want = ctr_fused_plain(kpf, j0c, le, xe)
        ok = all(torch.equal(run_ctr(f, "gcm", kpf, j0c, le, xe), want) for f in FORMS)
        edges[f"k3_w{we}"] = ok and bool(torch.equal(ctr_fused(kpf, j0c, le, xe), want))
        lanes = words(1, 128)
        wrap = lanes.clone()
        wrap[0, 0::4] = -32 * (we // 2) - 5
        lane_wrap = lanes.clone()
        lane_wrap[0, 0::4] = torch.tensor([-1 - (j % 7) for j in range(32)], dtype=torch.int32)
        ge = words(1, we)
        for bname, base in (("lanes", lanes), ("wrap", wrap), ("lane_wrap", lane_wrap)):
            want = sk.siv_ctrw_fused_plain(skpf, base, xe)
            ok = all(torch.equal(run_ctr(f, c, skpf, base, None, xe), want)
                     for f in FORMS for c in ("siv_words", "siv_planes"))
            edges[f"k5_w{we}_{bname}"] = ok and bool(
                torch.equal(sk.siv_ctrw_fused(skpf, base, xe), want))
            wo = sk.siv_open_fused_plain(skpf, base, ge, w1p, xe)
            ok = all(torch.equal(a, b) for c in ("siv_words", "siv_planes")
                     for a, b in zip(run_open(c, skpf, base, ge, w1p, xe), wo))
            go = sk.siv_open_fused(skpf, base, ge, w1p, xe)
            edges[f"k5open_w{we}_{bname}"] = ok and bool(
                torch.equal(go[0], wo[0]) and torch.equal(go[1], wo[1]))
    torch.cuda.synchronize()
    return {"checkout": str(root), "nvidia_smi": _smi(), "ms": ms, "equal_to_plain": same,
            "edges_equal": edges, "all_equal": all(same.values()) and all(edges.values()),
            "ptxas": _ptxas(log, ("probe_",))}


def main() -> int:
    args = sys.argv[1:]
    if not args or args[0] not in ("sass", "probe"):
        print(__doc__, file=sys.stderr)
        return 2
    root = Path(args[1]) if len(args) > 1 else HERE.parent.parent
    if args[0] == "sass":
        print(json.dumps(sass(root)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("k3_k5_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    out = probe(root)
    print(json.dumps(out), flush=True)
    return 0 if out.get("all_equal") else 1


if __name__ == "__main__":
    sys.exit(main())
