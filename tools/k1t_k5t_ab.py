#!/usr/bin/env python3
"""K1t (seal_fused.cu, `seal_fused_t`) and K5t (siv_fused.cu,
`siv_ctrw_fused_t`) of micro_aes_tpu_torch, the kernels that read and write
the transposed [128, W] stream in place, against their parent form (K1 or K5
between two torch transposes of the stream) and beside K1, K3, K5 and
K5-open, on one NVIDIA GPU.

    python3 tools/k1t_k5t_ab.py time [CHECKOUT_ROOT]
    python3 tools/k1t_k5t_ab.py ab PARENT_ROOT CHANGE_ROOT
    python3 tools/k1t_k5t_ab.py sass PARENT_ROOT CHANGE_ROOT
    python3 tools/k1t_k5t_ab.py probe [CHECKOUT_ROOT]

`time` builds the checkout's kernels and times, at chip_smoke.py's 16 MiB
shapes (AES-256 unless a name says otherwise), the checkout's
`seal_fused_t` (seal and open) and `siv_ctrw_fused_t`, each beside its
parent form built from the same library (`seal_fused` or `siv_ctrw_fused`
between `.T.contiguous()`s, name + `_parent`), K5t also at W = 32,801 (not a
multiple of 4), K1t and K5t at AES-128, and K1 (seal, open),
K3, K5 and K5-open: the profiler's device time (two means of 10 calls after
a warm-up) and CUDA events (three means of 10), with a digest of each
output, and whether each K1t/K5t output equals its parent form's bit for
bit.  In a checkout from before K1t and K5t had kernels of their own,
`seal_fused_t` and `siv_ctrw_fused_t` are the parent form.

`ab` runs `time` on PARENT, CHANGE, CHANGE, PARENT, each in its own process
(e.g. a `git archive` of the parent under the git-ignored `tree_check/`).

`sass` compiles seal_fused.cu, ctr_fused.cu and siv_fused.cu of both
checkouts to cubins with the checkouts' nvcc flags and says, for each
kernel of K1, K3, K5 and K5-open, whether its SASS is the same instruction
for instruction (kernels matched by name, less the file hash of their
anonymous namespace), with the instruction counts, and nvcc's `-Xptxas -v`
lines of every kernel of the change (K1t's and K5t's too).  Other tools
import `timed`, `sass` and `main` with their own kernels and sources.

`probe` builds, from the checkout's aes_bitslice.cuh and siv_fused.cu, K1t
and K5t as the checkout's bodies with and without an L2 prefetch of the
block's input under the cipher (a `prefetch.global.L2` for every 128-byte
line of each lane's run, issued before the body starts), and times both at
16 MiB AES-256, W = 32,800 and 32,801, in the order off, on, on, off; every
output is held bit for bit against the plain version.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve()
sys.path.insert(0, str(HERE.parent))

from k15_k1_ab import _cuda_ms, _device_ms, _digest, _smi  # noqa: E402
from spread_ab import _code  # noqa: E402

SEED = 37
N = 1 << 20  # 16 MiB of blocks, as chip_smoke.py
# the row-form kernels whose code the column form must leave as it was
ROW_FORM = ("seal_fused_kernel", "ctr_fused_kernel", "siv_ctr_kernel", "siv_open_kernel")
STEMS = ("seal_fused", "ctr_fused", "siv_fused")

PROBE_SRC = r"""
#include "siv_fused.cu"  // SivCounters, and aes_bitslice.cuh

namespace {

// Rows w0 .. min(w0 + ROWS, w) - 1 of the transposed stream, each lane a run
// of up to ROWS words, into L2: a prefetch at words 0, 32, .. of each run
// and at its last, so every 128-byte line the run touches, at addresses
// inside the run.
template <int ROWS>
__device__ __forceinline__ void prefetch_columns_l2(const uint32_t* src, int w0, int w) {
  constexpr int kPoints = ROWS / 32 + 1;
  const int n = min(ROWS, w - w0);
  for (int i = threadIdx.x; i < 128 * kPoints; i += blockDim.x) {
    const int l = i / kPoints, p = i % kPoints;
    const int off = p < kPoints - 1 ? 32 * p : n - 1;
    if (off < n)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(src + static_cast<size_t>(l) * w + w0 + off));
  }
}

template <bool OPEN, bool PREFETCH>
__global__ void __launch_bounds__(256, 1)
probe_k1t_kernel(const uint32_t* kp, const uint32_t* j0c, const uint32_t* lohi,
                 const uint32_t* ghm, const uint32_t* w1p, const uint32_t* in, uint32_t* out,
                 int8_t* s1, int rounds, int w) {
  extern __shared__ uint32_t smem[];
  if (PREFETCH) prefetch_columns_l2<256>(in, blockIdx.x * 256, w);
  uaes::ctr_level1_body<256, OPEN, uaes::StreamForm::kColumns>(
      smem, uaes::GcmCounters{j0c, lohi, w}, kp, ghm, w1p, in, out, s1, rounds, w);
}

template <bool PREFETCH>
__global__ void __launch_bounds__(128, 1)
probe_k5t_kernel(const uint32_t* kp, const uint32_t* basew, const uint32_t* in, uint32_t* out,
                 int rounds, int w) {
  extern __shared__ uint32_t smem[];
  if (PREFETCH) prefetch_columns_l2<128>(in, blockIdx.x * 128, w);
  uaes::ctr_xor_body<128, uaes::StreamForm::kColumns>(smem, SivCounters{basew}, kp, in, out,
                                                      rounds, w);
}

}  // namespace

extern "C" int probe_k1t(int prefetch, const uint32_t* kp, const uint32_t* j0c,
                         const uint32_t* lohi, const uint32_t* ghm, const uint32_t* w1p,
                         const uint32_t* in, uint32_t* out, int8_t* s1, int rounds, int w,
                         int open, cudaStream_t stream) {
  auto k = prefetch ? (open ? probe_k1t_kernel<true, true> : probe_k1t_kernel<false, true>)
                    : (open ? probe_k1t_kernel<true, false> : probe_k1t_kernel<false, false>);
  return uaes::launch_rows(k, 256, uaes::ctr_level1_smem_words(256), w, stream, kp, j0c, lohi,
                           ghm, w1p, in, out, s1, rounds, w);
}

extern "C" int probe_k5t(int prefetch, const uint32_t* kp, const uint32_t* basew,
                         const uint32_t* in, uint32_t* out, int rounds, int w,
                         cudaStream_t stream) {
  return uaes::launch_rows(prefetch ? probe_k5t_kernel<true> : probe_k5t_kernel<false>, 128,
                           uaes::ctr_xor_smem_words(128, uaes::StreamForm::kColumns), w, stream,
                           kp, basew, in, out, rounds, w);
}
"""


def _package(root: Path):
    sys.path.insert(0, str(root.resolve()))
    import micro_aes_tpu_torch

    here = Path(micro_aes_tpu_torch.__file__).resolve().parent.parent
    if here != root.resolve():
        raise RuntimeError(f"imported the package from {here}, not {root}")


def _words(rng, dev, *shape):
    import numpy as np
    import torch

    return torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint32)
                            .view(np.int32)).to(dev)


def _kernels(root: Path, dev, rng) -> dict:
    """name -> a call of one kernel (or parent form) at the 16 MiB shapes."""
    import numpy as np

    _package(root)
    from micro_aes_tpu_torch.modes import seal, siv_seal
    from micro_aes_tpu_torch.modes.seal import position_mask
    from micro_aes_tpu_torch.ops import siv_kernels as sk
    from micro_aes_tpu_torch.ops.counter import j0_planes, lohi_words
    from micro_aes_tpu_torch.ops.seal_kernels import ctr_fused, seal_fused, seal_fused_t

    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    kernels = {}
    w_seal = seal.seal_stream_words(N)
    for klen in (32, 16):
        kp, tables = seal.gcm_key_setup(rand(klen), device=dev)
        j0 = seal._j0_block(rand(12), dev)
        a = (kp.reshape(-1, 1), j0_planes(j0), lohi_words(j0, w_seal, -1),
             seal.ghash_mask(N, w_seal, dev), tables[5])
        pt = _words(rng, dev, w_seal, 128)
        pt_t = pt.T.contiguous()
        sfx = "" if klen == 32 else "_aes128"
        for opening in (False, True):
            d = "open" if opening else "seal"

            def parent(a=a, x=pt_t, o=opening):
                out, s1 = seal_fused(*a, x.T.contiguous(), o)
                return out.T.contiguous(), s1

            kernels[f"k1t_{d}{sfx}"] = lambda a=a, x=pt_t, o=opening: seal_fused_t(*a, x, o)
            kernels[f"k1t_{d}{sfx}_parent"] = parent
            if klen == 32:
                kernels[f"k1_{d}"] = lambda a=a, x=pt, o=opening: seal_fused(*a, x, o)
        if klen == 32:
            w_ctr = seal.stream_words(N + 1)  # as ctr_bulk
            a3 = (a[0], a[1], lohi_words(j0, w_ctr, -1), _words(rng, dev, w_ctr, 128))
            kernels["k3"] = lambda a=a3: ctr_fused(*a)
    ws = siv_seal._stream_words(N)
    front = 32 * ws - (N + 1)
    for klen in (32, 16):
        _, kp, tables = siv_seal._siv_key_setup(rand(klen), rand(12), dev)
        kpf, basew = kp.reshape(-1, 1), siv_seal._siv_basew(_words(rng, dev, 4), front)
        for w in ((ws, ws + 1) if klen == 32 else (ws,)):
            x = _words(rng, dev, w, 128)
            x_t = x.T.contiguous()
            tag = ("" if klen == 32 else "_aes128") + ("" if w == ws else f"_w{w}")
            kernels[f"k5t{tag}"] = lambda x=x_t, b=basew, k=kpf: sk.siv_ctrw_fused_t(k, b, x)
            kernels[f"k5t{tag}_parent"] = lambda x=x_t, b=basew, k=kpf: \
                sk.siv_ctrw_fused(k, b, x.T.contiguous()).T.contiguous()
            if klen == 32 and w == ws:
                ghm_open = position_mask(ws, front, 32 * ws - 1, dev)
                kernels["k5"] = lambda x=x, b=basew, k=kpf: sk.siv_ctrw_fused(k, b, x)
                kernels["k5open"] = lambda x=x, b=basew, k=kpf, g=ghm_open, t=tables[5]: \
                    sk.siv_open_fused(k, b, g, t, x)
    return kernels


def timed(root: Path, make=_kernels, seed: int = SEED) -> dict:
    """Times each kernel of make(root, device, rng): device ms (the
    profiler, 2 means of 10) and CUDA-event ms (3 means of 10), with output
    digests and whether each `name` equals its `name_parent` bit for bit."""
    import numpy as np
    import torch

    dev = torch.device("cuda", 0)
    kernels = make(root, dev, np.random.default_rng(seed))
    ms, dev_ms, sha = {}, {}, {}
    for name, fn in kernels.items():
        sha[name] = _digest(fn())
        ms[name] = [round(_cuda_ms(fn), 4) for _ in range(3)]
        dev_ms[name] = [round(_device_ms(fn), 4) for _ in range(2)]
    same = {name: sha[name] == sha[name + "_parent"] for name in kernels
            if name + "_parent" in kernels}
    return {"checkout": str(root), "nvidia_smi": _smi(), "device_ms": dev_ms, "kernel_ms": ms,
            "equal_to_parent_form": same, "sha256": sha}


# -- sass -----------------------------------------------------------------------

def _cubins(root: Path, tmp: Path, stems) -> tuple[dict, str]:
    """The checkout's csrc/<stem>.cu as cubins: (mangled kernel name -> SASS
    instructions, nvcc's output)."""
    _package(root)
    from micro_aes_tpu_torch.ops import _build

    csrc = root.resolve() / "micro_aes_tpu_torch" / "csrc"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    procs = []
    for stem in stems:
        out = tmp / f"{stem}.cubin"
        procs.append((out, subprocess.Popen(
            [_build._nvcc(), *flags, "-cubin", "-I", str(csrc), "-o", str(out),
             str(csrc / f"{stem}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, funcs = "", {}
    cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
    for out, proc in procs:
        log += proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
        text = subprocess.run([cuobjdump, "-sass", str(out)], capture_output=True, text=True,
                              check=True).stdout
        for func in text.split("Function : ")[1:]:
            name = func.split("\n", 1)[0].strip()
            # an anonymous namespace's mangled name carries a hash of its file
            name = re.sub(r"\d+_GLOBAL__N__[0-9a-f]{8}_\d+_(\w+?_cu)_[0-9a-f]{8}", r"anon_\1", name)
            funcs[name] = [t for _, t in _code(func)]
    return funcs, log


def _ops(body: list[str]) -> dict:
    ops: dict[str, int] = {}
    for text in body:
        op = text.split()[0]
        ops[op] = ops.get(op, 0) + 1
    return dict(sorted(ops.items(), key=lambda kv: -kv[1]))


def sass(parent: Path, change: Path, stems=STEMS, unchanged=ROW_FORM, new=()) -> dict:
    """For each kernel of `stems` whose name holds one of `unchanged`:
    whether its SASS is the parent's; the kernels named in `new` by opcode."""
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "p").mkdir()
        (Path(tmp) / "c").mkdir()
        pf, _ = _cubins(parent, Path(tmp) / "p", stems)
        sys.path.remove(str(parent.resolve()))
        for mod in [m for m in sys.modules if m.startswith("micro_aes_tpu_torch")]:
            del sys.modules[mod]
        cf, log = _cubins(change, Path(tmp) / "c", stems)
    sys.path.insert(0, str(change.resolve()))
    from chip_smoke import ptxas_summary

    same = {}
    for name in sorted(pf):
        if any(k in name for k in unchanged):
            same[name] = {"same_sass": pf[name] == cf.get(name),
                          "parent_instructions": len(pf[name]),
                          "change_instructions": len(cf.get(name, []))}
    return {"nvidia_smi": _smi(), "unchanged": same,
            "new": {name: {"instructions": len(body), "by_op": _ops(body)}
                    for name, body in cf.items() if any(k in name for k in new)},
            "change_kernels": {n: len(v) for n, v in cf.items()},
            "change_ptxas": ptxas_summary(log)}


# -- probe ----------------------------------------------------------------------

def probe(root: Path) -> dict:
    import numpy as np
    import torch

    _package(root)
    from micro_aes_tpu_torch.modes import seal, siv_seal
    from micro_aes_tpu_torch.ops import _build
    from micro_aes_tpu_torch.ops.counter import j0_planes, lohi_words
    from micro_aes_tpu_torch.ops.seal_kernels import seal_fused_t_plain
    from micro_aes_tpu_torch.ops.siv_kernels import siv_ctrw_fused_t_plain

    csrc = root.resolve() / "micro_aes_tpu_torch" / "csrc"
    with tempfile.TemporaryDirectory() as tmp:
        src, so = Path(tmp, "probe.cu"), Path(tmp, "libprobe.so")
        src.write_text(PROBE_SRC)
        built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-shared",
                                "-o", str(so), str(src)], capture_output=True, text=True)
        if built.returncode:
            return {"error": built.stdout + built.stderr}
        lib = ctypes.CDLL(str(so))
    ptxas = [ln.strip() for ln in (built.stdout + built.stderr).splitlines()
             if "probe_k" in ln or "Used" in ln or "spill" in ln]
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_k1t.argtypes = [I] + [P] * 8 + [I, I, I, P]
    lib.probe_k5t.argtypes = [I] + [P] * 4 + [I, I, P]

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def k1t(prefetch, a, x_t, opening):
        out = torch.empty_like(x_t)
        s1 = torch.empty((128, x_t.shape[1]), dtype=torch.int8, device=dev)
        err = lib.probe_k1t(prefetch, *(t.data_ptr() for t in a), x_t.data_ptr(),
                            out.data_ptr(), s1.data_ptr(), a[0].shape[0] // 128 - 1,
                            x_t.shape[1], int(opening), stream)
        assert err == 0, err
        return out, s1

    def k5t(prefetch, kpf, basew, x_t):
        out = torch.empty_like(x_t)
        err = lib.probe_k5t(prefetch, kpf.data_ptr(), basew.data_ptr(), x_t.data_ptr(),
                            out.data_ptr(), kpf.shape[0] // 128 - 1, x_t.shape[1], stream)
        assert err == 0, err
        return out

    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    cases = {}
    kp, tables = seal.gcm_key_setup(rand(32), device=dev)
    j0 = seal._j0_block(rand(12), dev)
    _, skp, _ = siv_seal._siv_key_setup(rand(32), rand(12), dev)
    skpf, basew = skp.reshape(-1, 1), _words(rng, dev, 1, 128)
    ws = siv_seal._stream_words(N)
    for w in (ws, ws + 1):
        a = (kp.reshape(-1, 1), j0_planes(j0), lohi_words(j0, w, -1),
             seal.ghash_mask(N, w, dev), tables[5])
        x_t = _words(rng, dev, 128, w)
        for opening in (False, True):
            cases[f"k1t_{'open' if opening else 'seal'}_w{w}"] = (
                lambda p, a=a, x=x_t, o=opening: k1t(p, a, x, o),
                seal_fused_t_plain(*a, x_t, opening))
        cases[f"k5t_w{w}"] = (lambda p, x=x_t: k5t(p, skpf, basew, x),
                              siv_ctrw_fused_t_plain(skpf, basew, x_t))
    out = {"checkout": str(root), "nvidia_smi": _smi(), "ptxas": ptxas, "device_ms": {},
           "kernel_ms": {}, "equal_to_plain": {}}
    labels = {0: "no_prefetch", 1: "prefetch"}
    for name, (fn, want) in cases.items():
        for p, label in labels.items():
            got = fn(p)
            got, want_ = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            out["equal_to_plain"][f"{name}_{label}"] = all(
                torch.equal(g, x) for g, x in zip(got, want_))
        dms = {label: [] for label in labels.values()}
        for p in (0, 1, 1, 0):
            dms[labels[p]].append(round(_device_ms(lambda: fn(p)), 4))
        out["device_ms"][name] = dms
        out["kernel_ms"][name] = {label: round(_cuda_ms(lambda: fn(p)), 4)
                                  for p, label in labels.items()}
    return out


def main(tool: Path = HERE, doc: str = __doc__, time_fn=timed, sass_fn=sass,
         probe_fn=probe) -> int:
    """The command line of `tool`: time, ab, sass and probe as in `doc`."""
    args = sys.argv[1:]
    if not args or args[0] not in ("time", "ab", "sass", "probe"):
        print(doc, file=sys.stderr)
        return 2
    if args[0] == "ab":
        rc = 0
        for root in (args[1], args[2], args[2], args[1]):
            rc |= subprocess.run([sys.executable, str(tool), "time", root]).returncode
        return rc
    if args[0] == "sass":
        print(json.dumps(sass_fn(Path(args[1]), Path(args[2]))), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print(f"{tool.stem}: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    root = Path(args[1]) if len(args) > 1 else tool.parent.parent
    print(json.dumps({"time": time_fn, "probe": probe_fn}[args[0]](root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
