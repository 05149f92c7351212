"""K8 (the single-key cipher-and-xor over a caller-supplied block stream),
K6 (the XTS body with in-kernel offsets base * alpha^jj) and K7 (the OCB
body with in-kernel gray-code offsets) on the w-major stream of
ops/seal_kernels.

  K8  ctrw_fused(kp_flat, ctr_words, pt_words)  = C_K(ctr_words) ^ pt_words
  K6  xex_fused(kp_flat, base_words, pt_words)  = off ^ C_K(pt_words ^ off),
      off at lane 4jj+k of a row = word k of (base of block jj) * alpha^jj
  K7  ocb_fused(kp_flat, d0l, lbl, pt_words, nbits)
                                                = D ^ C_K(pt_words ^ D),
      D of block i = 32 row + jj + 1 (mod 2^32): D_0 ^ XOR over the set bits
      b < nbits of gray(i) = i ^ (i >> 1) of L_b

C_K is E_K, or D_K with decrypt=True.  Every lane of `base_words`, `d0l`
and `lbl` counts on its own, as in the JAX twins (the bulk engines
replicate a block over its lane group).  Each wrapper dispatches on the
device of its stream: on CUDA it launches the hand-written kernel
(csrc/xex_fused.cu) or raises, on the CPU it runs the plain PyTorch version
(which follows the JAX package's ctrw_fused_jnp, xex_fused_jnp and
ocb_fused_jnp).  There is no fallback from CUDA to the plain versions.
"""
from __future__ import annotations

import torch

from . import _build
from .seal_kernels import _KP_SHAPES, _M32, _check_words, _device, ctrw_fused_plain


def _alpha_pow_words(x: torch.Tensor, m: int) -> torch.Tensor:
    """alpha^m (m <= 16) of each block of an int32 [W, 128] stream (lane
    4j+k = word k of block j): a shift of the little-endian 128-bit value by
    m with the carries between its words, and the 0x87 taps of the m bits
    that fall out of word 3.  Right shifts of int32 are arithmetic, so each
    is masked to the bits that move."""
    lanes = torch.arange(128, device=x.device)
    word0 = (lanes % 4 == 0)[None, :]
    top = (x >> (32 - m)) & ((1 << m) - 1)           # the bits leaving each word
    y = (x << m) | torch.where(word0, 0, torch.roll(top, 1, dims=1))
    ov = torch.roll(top, -3, dims=1)                 # word 3's bits, at word 0
    red = torch.zeros_like(x)
    for i in range(m):
        red = red ^ ((0x87 << i) * ((ov >> i) & 1))
    return y ^ torch.where(word0, red, 0)


def xex_offsets(base_words: torch.Tensor) -> torch.Tensor:
    """The offset stream that K6 expands: lane group jj of every row times
    alpha^jj, by five masked stages (m = 1, 2, 4, 8, 16)."""
    x = base_words.view(torch.int32)
    jj = torch.arange(128, device=x.device)[None, :] // 4
    for b in range(5):
        x = torch.where((jj >> b) & 1 == 1, _alpha_pow_words(x, 1 << b), x)
    return x


def ocb_offsets(d0l: torch.Tensor, lbl: torch.Tensor, w: int, nbits: int) -> torch.Tensor:
    """The offset stream that K7 builds: block i = 32 row + lane // 4 + 1
    (mod 2^32) takes D_0 ^ XOR of L_b over the set bits b < nbits of
    gray(i)."""
    dev = d0l.device
    lanes = torch.arange(128, device=dev)
    i = (32 * torch.arange(w, dtype=torch.int64, device=dev)[:, None] + lanes // 4 + 1) & _M32
    g = i ^ (i >> 1)
    table = lbl.view(torch.int32)
    offs = d0l.view(torch.int32).expand(w, 128)
    for b in range(nbits):
        offs = offs ^ torch.where((g >> b) & 1 == 1, table[b: b + 1], 0)
    return offs


def xex_fused_plain(kp_flat, base_words, pt_words, decrypt: bool = False):
    """Plain PyTorch version of xex_fused (same contract)."""
    off = xex_offsets(base_words)
    return ctrw_fused_plain(kp_flat, pt_words.view(torch.int32) ^ off, off,
                            decrypt).view(pt_words.dtype)


def ocb_fused_plain(kp_flat, d0l, lbl, pt_words, nbits: int, decrypt: bool = False):
    """Plain PyTorch version of ocb_fused (same contract)."""
    off = ocb_offsets(d0l, lbl, pt_words.shape[0], nbits)
    return ctrw_fused_plain(kp_flat, pt_words.view(torch.int32) ^ off, off,
                            decrypt).view(pt_words.dtype)


def _check(name, pt_words, kp_flat, streams=(), tables=()):
    """Raise on what the kernels do not take -> W."""
    _check_words(name, pt_words=pt_words, kp_flat=kp_flat, **dict(streams), **dict(tables))
    w = pt_words.shape[0]
    if tuple(kp_flat.shape) not in _KP_SHAPES:
        raise ValueError(f"{name}: kp_flat shape {tuple(kp_flat.shape)}")
    for arg, t in (("pt_words", pt_words), *streams):
        if tuple(t.shape) != (w, 128):
            raise ValueError(f"{name}: {arg} shape {tuple(t.shape)}, W={w}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    return w


def _launch(name, entry, *args):
    lib = _build.load()
    dev = args[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(*(a.data_ptr() if torch.is_tensor(a) else a for a in args),
                                  stream)
    _build.check_launch(name, err)


def ctrw_fused(kp_flat, ctr_words, pt_words, decrypt: bool = False):
    """K8: kp_flat [(R+1)*128, 1] key planes, ctr_words and pt_words
    [W, 128] -> C_K(ctr_words) ^ pt_words [W, 128]."""
    if _device("ctrw_fused", pt_words).type == "cpu":
        return ctrw_fused_plain(kp_flat, ctr_words, pt_words, decrypt)
    w = _check("ctrw_fused", pt_words, kp_flat, streams=(("ctr_words", ctr_words),))
    out = torch.empty_like(pt_words)
    if w:
        _launch("ctrw_fused", "micro_aes_ctrw_fused", kp_flat, ctr_words, pt_words, out,
                kp_flat.shape[0] // 128 - 1, w, int(decrypt))
        ctrw_fused.launches += 1
    return out


ctrw_fused.launches = 0


def xex_fused(kp_flat, base_words, pt_words, decrypt: bool = False):
    """K6: kp_flat as for ctrw_fused, base_words [W, 128] (lane 4jj+k = word k
    of the base of block jj of the row), pt_words [W, 128] -> the XEX body
    off ^ C_K(pt ^ off), off = base * alpha^jj, [W, 128]."""
    if _device("xex_fused", pt_words).type == "cpu":
        return xex_fused_plain(kp_flat, base_words, pt_words, decrypt)
    w = _check("xex_fused", pt_words, kp_flat, streams=(("base_words", base_words),))
    out = torch.empty_like(pt_words)
    if w:
        _launch("xex_fused", "micro_aes_xex_fused", kp_flat, base_words, pt_words, out,
                kp_flat.shape[0] // 128 - 1, w, int(decrypt))
        xex_fused.launches += 1
    return out


xex_fused.launches = 0


def ocb_fused(kp_flat, d0l, lbl, pt_words, nbits: int, decrypt: bool = False):
    """K7: kp_flat as for ctrw_fused, d0l [1, 128] and lbl [>= nbits, 128]
    (lane 4jj+k = word k of D_0 or L_b for block jj), pt_words [W, 128] with
    block index stream position + 1 -> the OCB body D ^ C_K(pt ^ D) [W, 128]."""
    if _device("ocb_fused", pt_words).type == "cpu":
        return ocb_fused_plain(kp_flat, d0l, lbl, pt_words, nbits, decrypt)
    w = _check("ocb_fused", pt_words, kp_flat, tables=(("d0l", d0l), ("lbl", lbl)))
    if tuple(d0l.shape) != (1, 128) or lbl.dim() != 2 or lbl.shape[1] != 128:
        raise ValueError(f"ocb_fused: d0l {tuple(d0l.shape)}, lbl {tuple(lbl.shape)}")
    if not 0 <= nbits <= min(32, lbl.shape[0]):
        raise ValueError(f"ocb_fused: nbits {nbits} with {lbl.shape[0]} rows of L_b")
    out = torch.empty_like(pt_words)
    if w:
        _launch("ocb_fused", "micro_aes_ocb_fused", kp_flat, d0l, lbl, pt_words, out, nbits,
                kp_flat.shape[0] // 128 - 1, w, int(decrypt))
        ocb_fused.launches += 1
    return out


ocb_fused.launches = 0
