"""K9: the multi-key cipher-and-xor, one key per message, in one launch.

`ctrw_fused_multikey(kp_stack, ctr_words, pt_words, b)` computes, for B
messages of Wm stream rows each (rows concatenated message after message),
out = pt ^ E_k(ctr) (or D_k(ctr)) under message i's key for rows
i*Wm .. (i+1)*Wm-1.  The stream is the w-major layout of ops/seal_kernels:
row w holds blocks 32w..32w+31, lane 4j+k = little-endian word k of block
32w+j.  The ragged batch GCM (modes/bulk) runs its keystreams through it.

It dispatches on the device of the stream: on CUDA it launches the
hand-written kernel (csrc/multikey.cu) or raises; on the CPU it runs
`ctrw_fused_multikey_plain`, the plain PyTorch version (which follows the
JAX package's ctrw_fused_multikey_jnp).

The kernel derives each message's broadcast key planes from its round-key
bytes (B x (R+1) x 16) instead of reading (R+1) x 512 bytes of planes per
message; the wrapper keeps the JAX package's kp_stack contract and hands
the kernel the round keys that the planes encode.
"""
from __future__ import annotations

import torch

from ..core.bitslice import decrypt_planes, encrypt_planes, planes_to_words, words_to_planes
from . import _build
from .seal_kernels import _kwords_to_stream, _stream_to_kwords

# The JAX package's Pallas row tile (pallas_seal.SEAL_TILE_W): the window
# contract below pads to it so that both packages cut the same windows.
_TILE_W = 256

_WORD_DTYPES = (torch.int32, torch.uint32)


def mk_window_words(nblocks: int) -> int:
    """Stream rows per message window for a message of nblocks blocks:
    ceil(nblocks/32) padded to a multiple of 8, and further (by at most 56
    rows) until a row tile of at least 64 divides it.  The one definition
    of the window, shared by the batch engine and chip_smoke.py."""
    wm = -(-nblocks // 32)
    wm += (-wm) % 8
    while wm >= 64 and mk_tile(wm) < 64:
        wm += 8
    return wm


def mk_tile(wm: int) -> int:
    """Largest multiple of 8 up to _TILE_W that divides wm."""
    best = 8
    for t in range(8, min(wm, _TILE_W) + 1, 8):
        if wm % t == 0:
            best = t
    return best


def _rounds_of(kp_stack: torch.Tensor, b: int) -> int:
    rounds = kp_stack.shape[0] // (b * 128) - 1
    if kp_stack.shape != (b * (rounds + 1) * 128, 1) or rounds not in (10, 12, 14):
        raise ValueError(f"ctrw_fused_multikey: kp_stack shape {tuple(kp_stack.shape)} for b={b}")
    return rounds


def ctrw_fused_multikey_plain(kp_stack, ctr_words, pt_words, b: int,
                              decrypt: bool = False):
    """Plain PyTorch version of ctrw_fused_multikey (same contract)."""
    i32 = torch.int32
    rounds = _rounds_of(kp_stack, b)
    wm = pt_words.shape[0] // b
    kp = kp_stack.view(i32).reshape(b, rounds + 1, 8, 16)
    kpw = kp.permute(1, 2, 3, 0).repeat_interleave(wm, dim=3)  # a key per row
    ctr = words_to_planes(_stream_to_kwords(ctr_words.view(i32)))
    ks = (decrypt_planes if decrypt else encrypt_planes)(kpw, ctr)
    out = _kwords_to_stream(planes_to_words(ks)) ^ pt_words.view(i32)
    return out.view(pt_words.dtype)


def _round_key_bytes(kp_stack: torch.Tensor, b: int, rounds: int) -> torch.Tensor:
    """kp_stack (0/-1 plane words) -> the round-key stack uint8[B,R+1,16]
    it encodes: byte p of round r = sum_b bit(plane (r, b, p)) << b."""
    bits = kp_stack.view(torch.int32).reshape(b, rounds + 1, 8, 16) & 1
    shifts = torch.arange(8, dtype=torch.int32, device=kp_stack.device)[:, None]
    return (bits << shifts).sum(dim=2).to(torch.uint8)


def ctrw_fused_multikey(kp_stack, ctr_words, pt_words, b: int,
                        decrypt: bool = False):
    """kp_stack [B*(R+1)*128, 1] (B stacked key_planes, core/bitslice),
    ctr_words and pt_words [B*Wm, 128] int32 or uint32 streams ->
    [B*Wm, 128]: pt ^ E_k(ctr) per message (D_k when decrypt)."""
    dev = pt_words.device
    if dev.type == "cpu":
        return ctrw_fused_multikey_plain(kp_stack, ctr_words, pt_words, b, decrypt)
    if dev.type != "cuda":
        raise ValueError(f"ctrw_fused_multikey: no kernel for device {dev}")
    for name, t in (("kp_stack", kp_stack), ("ctr_words", ctr_words), ("pt_words", pt_words)):
        if t.device != dev:
            raise ValueError(f"ctrw_fused_multikey: {name} is on {t.device}, expected {dev}")
        if t.dtype not in _WORD_DTYPES:
            raise TypeError(f"ctrw_fused_multikey: {name} must be int32 or uint32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ctrw_fused_multikey: {name} must be contiguous")
    rounds = _rounds_of(kp_stack, b)
    rows = pt_words.shape[0]
    if b <= 0 or rows % b or pt_words.shape != (rows, 128) or ctr_words.shape != (rows, 128):
        raise ValueError(f"ctrw_fused_multikey: streams {tuple(ctr_words.shape)}, "
                         f"{tuple(pt_words.shape)} for b={b}")
    if ctr_words.data_ptr() % 16 or pt_words.data_ptr() % 16:
        raise ValueError("ctrw_fused_multikey: streams must be 16-byte aligned")
    out = torch.empty_like(pt_words)
    if rows == 0:
        return out
    rks = _round_key_bytes(kp_stack, b, rounds)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.micro_aes_ctrw_multikey(
            rks.data_ptr(), ctr_words.data_ptr(), pt_words.data_ptr(), out.data_ptr(),
            rounds, rows // b, rows, int(decrypt), stream)
    _build.check_launch("ctrw_fused_multikey", err)
    ctrw_fused_multikey.launches += 1
    return out


ctrw_fused_multikey.launches = 0
