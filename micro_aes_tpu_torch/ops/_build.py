"""Build and load the port's CUDA kernels.

`csrc/*.cu` are compiled with `nvcc` for Hopper (sm_90a), one nvcc process
per source, all started together, and linked into one shared library with
a plain C interface, at first use, into `_build/` beside the package
(git-ignored), and loaded with `ctypes`.  The library's file name carries
a hash of the sources and flags, so an edit rebuilds and a stale library
is never loaded; a finished build is renamed into place in one step, so
concurrent first uses cannot load a half-written file.

Nothing here runs at import: the CPU tests import every module of the
package on machines without `nvcc`.

`csrc/sbox_inv.cuh` is generated from core/bitslice's derived inverse
S-box programs by `render_inv_sbox_header()`; a test pins the committed
file to it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from types import SimpleNamespace

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: every pointer and the stream as c_void_p; each returns
# cudaGetLastError() after its launch.
_SIGNATURES = {
    "micro_aes_cipher_planes": (_P, _P, _P, _I, _I, _I, _P),
    "micro_aes_seal_fused": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "micro_aes_ctr_fused": (_P, _P, _P, _P, _P, _I, _I, _P),
    "micro_aes_multikey": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "micro_aes_multikey_ragged": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "micro_aes_gcm_chain": (_P,) * 13 + (_I, _I, _I, _I, _P),
    "micro_aes_ghash1_fused": (_P, _P, _P, _P, _I, _P),
    "micro_aes_siv_ctrw_fused": (_P, _P, _P, _P, _I, _I, _P),
    "micro_aes_siv_open_fused": (_P,) * 7 + (_I, _I, _P),
    "micro_aes_ctrw_fused": (_P, _P, _P, _P, _I, _I, _I, _P),
    "micro_aes_xex_fused": (_P, _P, _P, _P, _I, _I, _I, _P),
    "micro_aes_ocb_fused": (_P,) * 5 + (_I, _I, _I, _I, _P),
    "micro_aes_chain_packed": (_P,) * 8 + (_I,) * 5 + (_P,),
    "micro_aes_chain_ragged": (_P,) * 5 + (_I, _I, _P),
    "micro_aes_ctr_packed": (_P,) * 5 + (_I, _I, _I, _I, _P),
    "micro_aes_kw_wheel": (_P, _P, _P) + (_I,) * 5 + (_P,),
    "micro_aes_kw_ragged": (_P,) * 4 + (_I, _I, _P),
}


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# What the last build in this process did: the library path, the seconds
# nvcc took (0.0 when an identical library was already built) and nvcc's
# output (register and spill counts from `-Xptxas -v`).
build_info = SimpleNamespace(path=None, seconds=0.0, log="")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build() -> Path:
    """Compile csrc/*.cu into BUILD_DIR (once per source hash); return the
    library path.  Raises RuntimeError with nvcc's output on failure."""
    out = BUILD_DIR / f"libmicro_aes_kernels_{_digest()}.so"
    build_info.path = out
    if out.exists():
        build_info.seconds, build_info.log = 0.0, ""
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in _sources()]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(_sources(), objs)]
    logs = [p.communicate()[0] for p in procs]
    rc = next((p.returncode for p in procs if p.returncode), 0)
    if rc == 0:
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        rc = link.returncode
        logs.append(link.stdout + link.stderr)
    build_info.seconds = time.perf_counter() - t0
    build_info.log = "".join(logs)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if rc != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({rc}):\n{build_info.log}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.micro_aes_error_string.argtypes = [ctypes.c_int]
            lib.micro_aes_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check_launch(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = load().micro_aes_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: error {err} ({msg})")


def render_inv_sbox_header() -> str:
    """C++ text of csrc/sbox_inv.cuh: core/bitslice's derived inverse S-box
    linear layers as straight-line XOR code (the 0x63 input constant as NOTs
    on the input planes, the output constants as NOTs on the outputs)."""
    from ..core.bitslice import (
        _C_BITS,
        _INV_BOT_CONST,
        _INV_BOT_OPS,
        _INV_BOT_OUT,
        _INV_TOP_OPS,
        _INV_TOP_OUT,
    )

    def program(inputs, ops, outs, out_name, consts=None):
        lines = []
        names = list(inputs)
        for n, (a, b) in enumerate(ops):
            name = f"g{n}"
            lines.append(f"  const uint32_t {name} = {names[a]} ^ {names[b]};")
            names.append(name)
        for k, idx in enumerate(outs):
            val = names[idx] if idx >= 0 else "0u"
            if consts is not None and consts[k]:
                val = f"~{val}"
            lines.append(f"  {out_name}[{k}] = {val};")
        return lines

    top_in = [f"i{b}" for b in range(8)]
    top_decl = [f"  const uint32_t i{b} = {'~' if _C_BITS[b] else ''}x[{b}];"
                for b in range(8)]
    bot_in = [f"z[{j}]" for j in range(18)]
    text = [
        "// Generated by micro_aes_tpu_torch.ops._build.render_inv_sbox_header()",
        "// from the inverse S-box programs that core/bitslice.py derives at import",
        "// (randomized-restart Paar CSE, seed 0).  Do not edit: a test pins this",
        "// file to the derivation.",
        "#pragma once",
        "",
        "#include <cstdint>",
        "",
        "namespace uaes {",
        "",
        f"// {len(_INV_TOP_OPS)} XORs: planes x (LSB-first) -> the 22 middle inputs.",
        "__device__ __forceinline__ void inv_top(const uint32_t (&x)[8], uint32_t (&y)[22]) {",
        *top_decl,
        *program(top_in, _INV_TOP_OPS, _INV_TOP_OUT, "y"),
        "}",
        "",
        f"// {len(_INV_BOT_OPS)} XORs: the 18 middle products -> planes x (LSB-first).",
        "__device__ __forceinline__ void inv_bottom(const uint32_t (&z)[18], uint32_t (&x)[8]) {",
        *program(bot_in, _INV_BOT_OPS, _INV_BOT_OUT, "x", _INV_BOT_CONST),
        "}",
        "",
        "}  // namespace uaes",
        "",
    ]
    return "\n".join(text)
