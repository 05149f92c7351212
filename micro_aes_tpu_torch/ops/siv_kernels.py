"""K4 (level-1 GHASH/POLYVAL of a stream, no cipher) and K5 (GCM-SIV CTR
from in-kernel LE32 counters; its open form also folds the level-1
POLYVAL of its output) on the w-major stream of ops/seal_kernels.

The counter base is `basew` [1, 128]: lane 4j+k holds word k of the base
(the bulk engine replicates the tag, with bit 7 of byte 15 set and the
stream front subtracted from word 0, over j), and block j of stream row r
counts from it: counter words (basew[4j] + 32r + j mod 2^32, basew[4j+1],
basew[4j+2], basew[4j+3]).  Only word 0 counts, with no carry into word 1
(incBlock with index 0, micro_aes.c:421-428).

Every wrapper dispatches on the device of its stream: on CUDA it launches
the hand-written kernel (csrc/siv_fused.cu) or raises, on the CPU it runs
the plain PyTorch version (which follows the JAX package's
ghash1_fused_jnp, siv_ctrw_fused_jnp and siv_open_fused_jnp).  There is no
fallback from CUDA to the plain versions.  The level-1 table is the packed
W1p of ghash_bulk.pack_level1, as for K1 (the JAX kernels take the int8
W1^T, 512 KiB, which does not fit in a block's shared memory).  The `_t`
wrappers take the transposed [128, W] stream that the JAX package runs on
the TPU: `ghash1_fused_t` (K4t) and `siv_ctrw_fused_t` (K5t) launch
kernels of their own that read (K5t: and write) that layout in place (their
plain versions are K4's and K5's between transposes).
"""
from __future__ import annotations

import torch

from ..core.bitslice import words_to_planes
from ..utils.bytesio import i32_from_u32
from . import _build
from .seal_kernels import (
    _KP_SHAPES,
    _M32,
    _check_words,
    _device,
    _stream_to_kwords,
    ctrw_fused_plain,
    level1_plain,
)


def _siv_ctrw_stream(basew: torch.Tensor, w: int) -> torch.Tensor:
    """The counter stream int32[W, 128] that K5 builds in registers: lane
    4j+k of row r = basew[4j+k], plus 32r + j (mod 2^32) when k = 0."""
    dev = basew.device
    lanes = torch.arange(128, device=dev)
    pos = 32 * torch.arange(w, dtype=torch.int64, device=dev)[:, None] + lanes // 4
    base = basew.view(torch.int32).to(torch.int64) & _M32
    return i32_from_u32(torch.where(lanes % 4 == 0, (base + pos) & _M32, base))


def ghash1_fused_plain(ghm, w1p, x_words):
    """Plain PyTorch version of ghash1_fused (same contract)."""
    planes = words_to_planes(_stream_to_kwords(x_words.view(torch.int32)))
    return level1_plain(planes, ghm, w1p)


def siv_ctrw_fused_plain(kp_flat, basew, pt_words):
    """Plain PyTorch version of siv_ctrw_fused (same contract)."""
    return ctrw_fused_plain(kp_flat, _siv_ctrw_stream(basew, pt_words.shape[0]), pt_words)


def siv_open_fused_plain(kp_flat, basew, ghm, w1p, ct_words):
    """Plain PyTorch version of siv_open_fused (same contract)."""
    out = siv_ctrw_fused_plain(kp_flat, basew, ct_words)
    return out, ghash1_fused_plain(ghm, w1p, out)


def _check_stream(name, x_words, transposed=False, **operands):
    _check_words(name, x_words=x_words, **operands)
    w = x_words.shape[-1 if transposed else 0]
    if x_words.shape != ((128, w) if transposed else (w, 128)):
        raise ValueError(f"{name}: stream shape {tuple(x_words.shape)}")
    if x_words.data_ptr() % 16:
        raise ValueError(f"{name}: stream must be 16-byte aligned")
    shapes = {"kp_flat": _KP_SHAPES, "basew": ((1, 128),), "ghm": ((1, w),),
              "w1p": ((128, 128),)}
    for arg, t in operands.items():
        if tuple(t.shape) not in shapes[arg]:
            raise ValueError(f"{name}: {arg} shape {tuple(t.shape)}, W={w}")
    return w


def _launch_ghash1(name, ghm, w1p, x, transposed):
    """Check the operands of K4 (x [W, 128]) or K4t (x [128, W], its own
    kernel) on CUDA and launch it -> s1 int8[128, W]."""
    w = _check_stream(name, x, transposed, ghm=ghm, w1p=w1p)
    s1 = torch.empty((128, w), dtype=torch.int8, device=x.device)
    if w == 0:
        return s1
    entry = getattr(_build.load(), f"micro_aes_{name}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = entry(ghm.data_ptr(), w1p.data_ptr(), x.data_ptr(), s1.data_ptr(), w, stream)
    _build.check_launch(name, err)
    return s1


def ghash1_fused(ghm, w1p, x_words):
    """K4: ghm [1, W] (bit j of word w set = stream position 32w+j counts),
    w1p [128, 128] (the packed level-1 table of the per-key tables),
    x_words [W, 128] -> s1 int8[128, W], s1[:, w] the level-1 partial of
    the 32-block row w.  GHASH or POLYVAL: the convention lives in the
    table."""
    if _device("ghash1_fused", x_words).type == "cpu":
        return ghash1_fused_plain(ghm, w1p, x_words)
    s1 = _launch_ghash1("ghash1_fused", ghm, w1p, x_words, False)
    ghash1_fused.launches += 1
    return s1


ghash1_fused.launches = 0


def ghash1_fused_t_plain(ghm, w1p, x_t):
    """Plain PyTorch version of ghash1_fused_t: ghash1_fused_plain on the
    transpose (the CPU's path and the card tests' reference)."""
    return ghash1_fused_plain(ghm, w1p, x_t.T.contiguous())


def ghash1_fused_t(ghm, w1p, x_t):
    """K4t: ghash1_fused on the transposed stream x_t [128, W] (column w,
    lane 4j+k = word k of block 32w+j) -> s1 int8[128, W].  On CUDA its own
    kernel reads this layout in place, with no transpose
    (csrc/siv_fused.cu)."""
    if _device("ghash1_fused_t", x_t).type == "cpu":
        return ghash1_fused_t_plain(ghm, w1p, x_t)
    s1 = _launch_ghash1("ghash1_fused_t", ghm, w1p, x_t, True)
    ghash1_fused_t.launches += 1
    return s1


ghash1_fused_t.launches = 0


def _launch_ctrw(name, kp_flat, basew, x, transposed):
    """Check the operands of K5 (x [W, 128]) or K5t (x [128, W], its own
    kernel) on CUDA and launch it -> the output, shaped as x."""
    w = _check_stream(name, x, transposed, kp_flat=kp_flat, basew=basew)
    out = torch.empty_like(x)
    if w == 0:
        return out
    entry = getattr(_build.load(), f"micro_aes_{name}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = entry(kp_flat.data_ptr(), basew.data_ptr(), x.data_ptr(), out.data_ptr(),
                    kp_flat.shape[0] // 128 - 1, w, stream)
    _build.check_launch(name, err)
    return out


def siv_ctrw_fused(kp_flat, basew, pt_words):
    """K5: kp_flat [(R+1)*128, 1] key planes, basew [1, 128] (the module
    note), pt_words [W, 128] -> the stream xored with the GCM-SIV
    keystream [W, 128] (seal and open alike)."""
    dev = _device("siv_ctrw_fused", pt_words)
    if dev.type == "cpu":
        return siv_ctrw_fused_plain(kp_flat, basew, pt_words)
    out = _launch_ctrw("siv_ctrw_fused", kp_flat, basew, pt_words, False)
    siv_ctrw_fused.launches += 1
    return out


siv_ctrw_fused.launches = 0


def siv_ctrw_fused_t_plain(kp_flat, basew, pt_t):
    """Plain PyTorch version of siv_ctrw_fused_t: siv_ctrw_fused_plain
    between transposes (the CPU's path and the card tests' reference)."""
    return siv_ctrw_fused_plain(kp_flat, basew, pt_t.T.contiguous()).T.contiguous()


def siv_ctrw_fused_t(kp_flat, basew, pt_t):
    """K5t: siv_ctrw_fused on the transposed stream pt_t [128, W] (column w,
    lane 4j+k = word k of block 32w+j) -> [128, W].  On CUDA its own kernel
    reads and writes this layout in place, with no transpose
    (csrc/siv_fused.cu)."""
    dev = _device("siv_ctrw_fused_t", pt_t)
    if dev.type == "cpu":
        return siv_ctrw_fused_t_plain(kp_flat, basew, pt_t)
    out = _launch_ctrw("siv_ctrw_fused_t", kp_flat, basew, pt_t, True)
    siv_ctrw_fused_t.launches += 1
    return out


siv_ctrw_fused_t.launches = 0


def siv_open_fused(kp_flat, basew, ghm, w1p, ct_words):
    """K5-open: siv_ctrw_fused, then the level-1 partials of its OUTPUT
    (the recovered plaintext) masked by ghm, as ghash1_fused would give
    them -> (pt_words [W, 128], s1 int8[128, W])."""
    dev = _device("siv_open_fused", ct_words)
    if dev.type == "cpu":
        return siv_open_fused_plain(kp_flat, basew, ghm, w1p, ct_words)
    w = _check_stream("siv_open_fused", ct_words, kp_flat=kp_flat, basew=basew,
                      ghm=ghm, w1p=w1p)
    if w1p.data_ptr() % 16:  # staged for the tensor cores as 16-byte words
        raise ValueError("siv_open_fused: w1p must be 16-byte aligned")
    out = torch.empty_like(ct_words)
    s1 = torch.empty((128, w), dtype=torch.int8, device=dev)
    if w == 0:
        return out, s1
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.micro_aes_siv_open_fused(kp_flat.data_ptr(), basew.data_ptr(), ghm.data_ptr(),
                                           w1p.data_ptr(), ct_words.data_ptr(), out.data_ptr(),
                                           s1.data_ptr(), kp_flat.shape[0] // 128 - 1, w,
                                           stream)
    _build.check_launch("siv_open_fused", err)
    siv_open_fused.launches += 1
    return out, s1


siv_open_fused.launches = 0
