#!/usr/bin/env python3
"""K8 (xex_fused.cu, `ctrw_fused`: the cipher-and-xor of a caller's block
stream) and K4t (siv_fused.cu, `ghash1_fused_t`: level-1 POLYVAL of the
transposed [128, W] stream) of micro_aes_tpu_torch, beside K2, K3, K4, K5,
K5t, K6 and K7, on one NVIDIA GPU.

    python3 tools/k8_k4t_ab.py time [CHECKOUT_ROOT]
    python3 tools/k8_k4t_ab.py ab PARENT_ROOT CHANGE_ROOT
    python3 tools/k8_k4t_ab.py sass PARENT_ROOT CHANGE_ROOT
    python3 tools/k8_k4t_ab.py probe [CHECKOUT_ROOT]

`time` builds the checkout's kernels and times, at chip_smoke.py's 16 MiB
shapes (AES-256 unless a name says otherwise): K8 both ways at W = 32,768
and 32,769 and at AES-128; K4t at W = 32,800 and 32,801 beside its parent
form (K4 behind one `.T.contiguous()` of the stream, from the same library,
name + `_parent`); K2 both ways, K3, K4, K5, K5t, K6 and K7 both ways: the
profiler's device time (two means of 10 calls after a warm-up) and CUDA
events (three means of 10), with a digest of each output and whether each
K4t output equals its parent form's bit for bit (k1t_k5t_ab.timed).  In a checkout from before
K4t had a kernel of its own, `ghash1_fused_t` is the parent form.

`ab` runs `time` on PARENT, CHANGE, CHANGE, PARENT, each in its own process
(e.g. a `git archive` of the parent under the git-ignored `tree_check/`).

`sass` compiles cipher_planes.cu, seal_fused.cu, ctr_fused.cu, siv_fused.cu
and xex_fused.cu of both checkouts to cubins with the checkouts' nvcc flags
and says, for each kernel the change must leave as it was (K1, K1t, K2,
K3, K4, K5, K5t, K5-open, K6, K7), whether its SASS is the same
instruction for instruction (kernels matched by name, less the file hash
of their anonymous namespace), with the instruction counts; the change's
new kernels (K8, K4t) by opcode; and nvcc's `-Xptxas -v` lines of every
kernel of the change (k1t_k5t_ab.sass).

`probe` builds micro-kernels from the checkout's aes_bitslice.cuh and
xex_fused.cu and times them at 16 MiB, each output held bit for bit
against its plain version:
  * K8's cipher input in four forms, each with the xor rows copied by TMA
    under the cipher: `rows` (K8 itself, micro_aes_ctrw_fused: each thread
    reads its own row of the blocks stream from device memory after the
    block's barrier), `staged` (the block's blocks rows by TMA first, on phase
    0 of the mbarrier; each thread takes its row from shared memory by
    LDS.128, one __syncthreads, then the xor rows by TMA into the same area
    on phase 1) and `early` (the `rows` loads issued before the block stages
    its key planes) and `late` (the `rows` form with the xor rows' copy
    issued once the block's first thread has its row, not at the start),
    AES-256 both ways at W = 32,768 and 32,769, in the order rows, staged,
    early, late, late, early, staged, rows;
  * K4t's B-operand stores: 256 threads each storing a row of 32 STS.128
    at rows + t * stride + 4q, in clock cycles per warp-wide store, at
    stride 132 (K4t's kL1Stride), 128 (8 threads of a quarter-warp on the
    same banks) and the consecutive pattern (thread t at 16 t bytes, known
    to be free of conflicts).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve()
sys.path.insert(0, str(HERE.parent))

from k15_k1_ab import _cuda_ms, _device_ms, _smi  # noqa: E402
from k1t_k5t_ab import _package, _words, main, sass, timed  # noqa: E402

SEED = 41
N = 1 << 20  # 16 MiB of blocks, as chip_smoke.py
# the kernels whose code the change must leave as it was
UNCHANGED = ("seal_fused_kernel", "seal_fused_t_kernel", "cipher_planes_kernel",
             "ctr_fused_kernel", "ghash1_fused_kernel", "siv_ctr_kernel", "siv_ctr_t_kernel",
             "siv_open_kernel", "AlphaOffsets", "GrayOffsets")
NEW = ("ctrw_fused_kernel", "ghash1_fused_t_kernel")
STEMS = ("cipher_planes", "seal_fused", "ctr_fused", "siv_fused", "xex_fused")

PROBE_SRC = r"""
#include "xex_fused.cu"  // load_row_planes, micro_aes_ctrw_fused, aes_bitslice.cuh

namespace {

constexpr int kProbeRows = 128;

// The planes of a staged row (16-byte aligned), read by LDS.128: rows
// kL1Stride apart put a quarter-warp's 8 threads on 32 distinct banks.
__device__ __forceinline__ void staged_row_planes(uint32_t (&s)[8][16], const uint32_t* row) {
  uint32_t a[4][32];
  const uint4* r4 = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const uint4 v = r4[j];
    a[0][j] = v.x;
    a[1][j] = v.y;
    a[2][j] = v.z;
    a[3][j] = v.w;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uaes::transpose32(a[k]);
#pragma unroll
    for (int r = 0; r < 32; ++r) s[r % 8][4 * k + r / 8] = a[k][r];
  }
}

// Rows w0 .. w0 + live - 1 into the stage area on the mbarrier's next
// phase (it was initialised by stage_rows_bulk and its phase 0 is done).
__device__ __forceinline__ void restage_rows_bulk(const uint32_t* src, uint32_t* stage,
                                                  uint64_t* bar, int w0, int live) {
  const unsigned b = uaes::smem_u32(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(live * 512)
               : "memory");
  for (int r = 0; r < live; ++r)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(uaes::smem_u32(stage + r * uaes::kL1Stride)),
        "l"(src + static_cast<size_t>(w0 + r) * 128), "r"(512), "r"(b)
        : "memory");
}

__device__ __forceinline__ void wait_phase1(uint64_t* bar) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 1; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(uaes::smem_u32(bar))
        : "memory");
}

// `staged`: the blocks rows by TMA first (phase 0), each thread's row from
// shared memory, one barrier, then the xor rows by TMA into the same area
// under the cipher (phase 1).  Shared memory as ctr_xor_body's.
template <bool DECRYPT>
__global__ void __launch_bounds__(kProbeRows)
probe_k8_staged(const uint32_t* kp, const uint32_t* blocks, const uint32_t* xw, uint32_t* out,
                int rounds, int w) {
  extern __shared__ uint32_t smem[];
  uint32_t* kps = smem;
  uint32_t* stage = kps + uaes::kMaxKeyPlaneWords + 128;
  uint64_t* bar = reinterpret_cast<uint64_t*>(stage + kProbeRows * uaes::kL1Stride);
  const int w0 = blockIdx.x * kProbeRows;
  const int live_rows = min(kProbeRows, w - w0);
  if (threadIdx.x == 0) uaes::stage_rows_bulk(blocks, stage, bar, w0, live_rows);
  uaes::copy_to_smem(kp, kps, (rounds + 1) * 128);
  __syncthreads();
  const int row = w0 + threadIdx.x;
  uint32_t s[8][16];
  uaes::wait_rows_bulk(bar);
  staged_row_planes(s, stage + threadIdx.x * uaes::kL1Stride);
  __syncthreads();  // every row is read: the area takes the xor rows
  if (threadIdx.x == 0) restage_rows_bulk(xw, stage, bar, w0, live_rows);
  if (DECRYPT) {
    uaes::decrypt_state(s, kps, rounds);
  } else {
    uaes::encrypt_state(s, kps, rounds);
  }
  uaes::planes_to_words(s);
  wait_phase1(bar);
  if (row < w) uaes::xor_words_into_row(s, stage + threadIdx.x * uaes::kL1Stride);
  __syncthreads();
  uaes::stage_rows_out_wide<kProbeRows>(stage, out, w0, w);
}

// `early`: `rows` with the thread's 32 row loads issued before the block
// stages its key planes.
template <bool DECRYPT>
__global__ void __launch_bounds__(kProbeRows)
probe_k8_early(const uint32_t* kp, const uint32_t* blocks, const uint32_t* xw, uint32_t* out,
               int rounds, int w) {
  extern __shared__ uint32_t smem[];
  uint32_t* kps = smem;
  uint32_t* stage = kps + uaes::kMaxKeyPlaneWords + 128;
  uint64_t* bar = reinterpret_cast<uint64_t*>(stage + kProbeRows * uaes::kL1Stride);
  const int w0 = blockIdx.x * kProbeRows;
  if (threadIdx.x == 0) uaes::stage_rows_bulk(xw, stage, bar, w0, min(kProbeRows, w - w0));
  const int row = w0 + threadIdx.x;
  const bool live = row < w;
  uint32_t a[4][32];
  const uint4* src = reinterpret_cast<const uint4*>(blocks) + static_cast<size_t>(row) * 32;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const uint4 v = live ? __ldg(src + j) : make_uint4(0u, 0u, 0u, 0u);
    a[0][j] = v.x;
    a[1][j] = v.y;
    a[2][j] = v.z;
    a[3][j] = v.w;
  }
  uaes::copy_to_smem(kp, kps, (rounds + 1) * 128);
  __syncthreads();
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
  uaes::planes_to_words(s);
  uaes::wait_rows_bulk(bar);
  if (live) uaes::xor_words_into_row(s, stage + threadIdx.x * uaes::kL1Stride);
  __syncthreads();
  uaes::stage_rows_out_wide<kProbeRows>(stage, out, w0, w);
}

// `late`: `rows` with the xor rows' TMA copy issued by the block's first
// thread once its own row has arrived, not at the start: the blocks rows,
// which the first round waits on, then have the memory system to themselves.
template <bool DECRYPT>
__global__ void __launch_bounds__(kProbeRows)
probe_k8_late(const uint32_t* kp, const uint32_t* blocks, const uint32_t* xw, uint32_t* out,
              int rounds, int w) {
  extern __shared__ uint32_t smem[];
  uint32_t* kps = smem;
  uint32_t* stage = kps + uaes::kMaxKeyPlaneWords + 128;
  uint64_t* bar = reinterpret_cast<uint64_t*>(stage + kProbeRows * uaes::kL1Stride);
  const int w0 = blockIdx.x * kProbeRows;
  if (threadIdx.x == 0) {
    const unsigned b = uaes::smem_u32(bar);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  uaes::copy_to_smem(kp, kps, (rounds + 1) * 128);
  __syncthreads();
  const int row = w0 + threadIdx.x;
  const bool live = row < w;
  uint32_t s[8][16];
  load_row_planes<false>(s, blocks, nullptr, row, live);
  if (threadIdx.x == 0) {
    // a branch on the row's planes: the copy cannot issue before they arrive
    if (s[0][0] == 0x9E3779B9u) __nanosleep(1);
    restage_rows_bulk(xw, stage, bar, w0, min(kProbeRows, w - w0));
  }
  if (DECRYPT) {
    uaes::decrypt_state(s, kps, rounds);
  } else {
    uaes::encrypt_state(s, kps, rounds);
  }
  uaes::planes_to_words(s);
  uaes::wait_rows_bulk(bar);
  if (live) uaes::xor_words_into_row(s, stage + threadIdx.x * uaes::kL1Stride);
  __syncthreads();
  uaes::stage_rows_out_wide<kProbeRows>(stage, out, w0, w);
}

// K4t's B-operand stores alone: `iters` times, each of 256 threads stores 32
// STS.128 at its row (stride words apart; stride 0: the consecutive pattern,
// store q of thread t at uint4 q * 256 + t); cycles[warp] = the warp's
// clock64 span.
__global__ void __launch_bounds__(256, 1)
probe_sts(int stride, int iters, long long* cycles, uint32_t* sink) {
  extern __shared__ uint32_t smem[];
  const int t = threadIdx.x;
  uint32_t v = t;
  __syncthreads();
  const long long c0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const uint32_t* p = stride ? smem + t * stride + 4 * q : smem + 4 * (q * 256 + t);
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(uaes::smem_u32(p)), "r"(v),
                   "r"(v + 1), "r"(v + 2), "r"(v + 3)
                   : "memory");
      v += 3;
    }
  }
  const long long c1 = clock64();
  __syncthreads();
  if ((t & 31) == 0) cycles[t >> 5] = c1 - c0;
  sink[t] = smem[t];
}

}  // namespace

extern "C" int probe_k8(int form, int decrypt, const uint32_t* kp, const uint32_t* blocks,
                        const uint32_t* xw, uint32_t* out, int rounds, int w,
                        cudaStream_t stream) {
  if (form == 0) return micro_aes_ctrw_fused(kp, blocks, xw, out, rounds, w, decrypt, stream);
  auto k = form == 1 ? (decrypt ? probe_k8_staged<true> : probe_k8_staged<false>)
         : form == 2 ? (decrypt ? probe_k8_early<true> : probe_k8_early<false>)
                     : (decrypt ? probe_k8_late<true> : probe_k8_late<false>);
  return uaes::launch_rows(k, kProbeRows, uaes::ctr_xor_smem_words(kProbeRows), w, stream, kp,
                           blocks, xw, out, rounds, w);
}

extern "C" int probe_sts_run(int stride, int iters, long long* cycles, uint32_t* sink,
                             cudaStream_t stream) {
  return uaes::launch_rows(probe_sts, 256, 256 * 132, 256, stream, stride, iters, cycles, sink);
}
"""


def _kernels(root: Path, dev, rng) -> dict:
    """name -> a call of one kernel (or parent form) at the 16 MiB shapes."""
    import numpy as np

    _package(root)
    from micro_aes_tpu_torch.modes import seal, siv_seal
    from micro_aes_tpu_torch.modes.seal import position_mask
    from micro_aes_tpu_torch.ops import siv_kernels as sk
    from micro_aes_tpu_torch.ops import xex_kernels as xk
    from micro_aes_tpu_torch.ops.cipher_kernel import cipher_planes
    from micro_aes_tpu_torch.ops.counter import j0_planes, lohi_words
    from micro_aes_tpu_torch.ops.seal_kernels import ctr_fused

    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    kernels = {}
    w = N // 32
    for klen in (32, 16):
        kp, _ = seal.gcm_key_setup(rand(klen), device=dev)
        kpf = kp.reshape(-1, 1)
        sfx = "" if klen == 32 else "_aes128"
        for wk in ((w, w + 1) if klen == 32 else (w,)):
            blocks, x = _words(rng, dev, wk, 128), _words(rng, dev, wk, 128)
            tag = sfx + ("" if wk == w else f"_w{wk}")
            for decrypt in (False, True):
                kernels[f"k8{'_dec' if decrypt else ''}{tag}"] = \
                    lambda b=blocks, x=x, d=decrypt, k=kpf: xk.ctrw_fused(k, b, x, d)
        if klen == 32:
            x, y = _words(rng, dev, w, 128), _words(rng, dev, w, 128)
            nbits = (32 * w).bit_length()
            d0l, lbl = _words(rng, dev, 1, 128), _words(rng, dev, nbits, 128)
            for decrypt in (False, True):
                d = "_dec" if decrypt else ""
                kernels[f"k6{d}"] = lambda y=y, x=x, dd=decrypt, k=kpf: xk.xex_fused(k, y, x, dd)
                kernels[f"k7{d}"] = lambda x=x, dd=decrypt, k=kpf, t=(d0l, lbl, nbits): \
                    xk.ocb_fused(k, t[0], t[1], x, t[2], dd)
            planes = _words(rng, dev, 8, 16, seal.stream_words(N + 2))
            for decrypt in (False, True):
                kernels[f"k2{'_dec' if decrypt else ''}"] = \
                    lambda p=planes, dd=decrypt, k=kp: cipher_planes(k, p, dd)
            j0 = seal._j0_block(rand(12), dev)
            w_ctr = seal.stream_words(N + 1)  # as ctr_bulk
            a3 = (kpf, j0_planes(j0), lohi_words(j0, w_ctr, -1), _words(rng, dev, w_ctr, 128))
            kernels["k3"] = lambda a=a3: ctr_fused(*a)
    ws = siv_seal._stream_words(N)
    front = 32 * ws - (N + 1)
    _, kp, tables = siv_seal._siv_key_setup(rand(32), rand(12), dev)
    kpf, w1p = kp.reshape(-1, 1), tables[5]
    basew = siv_seal._siv_basew(_words(rng, dev, 4), front)
    for wk in (ws, ws + 1):
        ghm = position_mask(wk, front, 32 * wk, dev)
        x = _words(rng, dev, wk, 128)
        x_t = x.T.contiguous()
        tag = "" if wk == ws else f"_w{wk}"
        kernels[f"k4t{tag}"] = lambda g=ghm, x=x_t: sk.ghash1_fused_t(g, w1p, x)
        kernels[f"k4t{tag}_parent"] = lambda g=ghm, x=x_t: sk.ghash1_fused(g, w1p, x.T.contiguous())
        if wk == ws:
            kernels["k4"] = lambda g=ghm, x=x: sk.ghash1_fused(g, w1p, x)
            kernels["k5"] = lambda x=x: sk.siv_ctrw_fused(kpf, basew, x)
            kernels["k5t"] = lambda x=x_t: sk.siv_ctrw_fused_t(kpf, basew, x)
    # the SIV key's names are bound last: nothing above closes over them
    return kernels


# -- probe ----------------------------------------------------------------------

def probe(root: Path) -> dict:
    import numpy as np
    import torch

    _package(root)
    from micro_aes_tpu_torch.modes import seal
    from micro_aes_tpu_torch.ops import _build
    from micro_aes_tpu_torch.ops.xex_kernels import ctrw_fused_plain

    csrc = root.resolve() / "micro_aes_tpu_torch" / "csrc"
    with tempfile.TemporaryDirectory() as tmp:
        src, so = Path(tmp, "probe.cu"), Path(tmp, "libprobe.so")
        src.write_text(PROBE_SRC)
        built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-shared",
                                "-o", str(so), str(src)], capture_output=True, text=True)
        if built.returncode:
            return {"error": built.stdout + built.stderr}
        lib = ctypes.CDLL(str(so))
    log = built.stdout + built.stderr
    ptxas = [ln.strip() for ln in log.splitlines()
             if "probe_" in ln or "Used" in ln or "spill" in ln]
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_k8.argtypes = [I, I, P, P, P, P, I, I, P]
    lib.probe_sts_run.argtypes = [I, I, P, P, P]

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def k8(form, kpf, blocks, x, decrypt):
        out = torch.empty_like(x)
        err = lib.probe_k8(form, int(decrypt), kpf.data_ptr(), blocks.data_ptr(), x.data_ptr(),
                           out.data_ptr(), kpf.shape[0] // 128 - 1, x.shape[0], stream)
        assert err == 0, err
        return out

    kp, _ = seal.gcm_key_setup(rng.integers(0, 256, 32, dtype=np.uint8).tobytes(), device=dev)
    kpf = kp.reshape(-1, 1)
    forms = {0: "rows", 1: "staged", 2: "early", 3: "late"}
    out = {"checkout": str(root), "nvidia_smi": _smi(), "ptxas": ptxas, "device_ms": {},
           "kernel_ms": {}, "equal_to_plain": {}}
    w = N // 32
    for wk in (w, w + 1):
        blocks, x = _words(rng, dev, wk, 128), _words(rng, dev, wk, 128)
        for decrypt in (False, True):
            name = f"k8{'_dec' if decrypt else ''}_w{wk}"
            want = ctrw_fused_plain(kpf, blocks, x, decrypt)
            for f, label in forms.items():
                out["equal_to_plain"][f"{name}_{label}"] = torch.equal(
                    k8(f, kpf, blocks, x, decrypt), want)
            dms = {label: [] for label in forms.values()}
            for f in (0, 1, 2, 3, 3, 2, 1, 0):
                dms[forms[f]].append(round(_device_ms(
                    lambda f=f: k8(f, kpf, blocks, x, decrypt)), 4))
            out["device_ms"][name] = dms
            out["kernel_ms"][name] = {label: round(_cuda_ms(
                lambda f=f: k8(f, kpf, blocks, x, decrypt)), 4) for f, label in forms.items()}
    cycles = torch.zeros(8, dtype=torch.int64, device=dev)
    sink = torch.zeros(256, dtype=torch.int32, device=dev)
    iters, sts = 64, {}
    for label, stride in (("stride_132", 132), ("stride_128", 128), ("consecutive", 0)):
        runs = []
        for _ in range(3):
            err = lib.probe_sts_run(stride, iters, cycles.data_ptr(), sink.data_ptr(), stream)
            assert err == 0, err
            torch.cuda.synchronize()
            runs.append(round(cycles.max().item() / (iters * 32), 3))
        sts[label] = runs
    out["sts128_cycles_per_warp_store"] = sts
    return out


if __name__ == "__main__":
    sys.exit(main(HERE, __doc__, lambda root: timed(root, _kernels, SEED),
                  lambda p, c: sass(p, c, STEMS, UNCHANGED, NEW), probe))
