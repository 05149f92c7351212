"""K1 (fused GCM seal/open body) and K3 (fused CTR) on the w-major stream.

The stream is `uint32[W, 128]`: row w holds blocks 32w..32w+31, lane 4j+k
= little-endian word k of block 32w+j — a free view of the byte stream.
Words are int32 or uint32 tensors of the same bits.

`seal_fused` and `ctr_fused` dispatch on the device of the stream: on CUDA
they launch the hand-written kernels (csrc/seal_fused.cu,
csrc/ctr_fused.cu) or raise; on the CPU they run `seal_fused_plain` /
`ctr_fused_plain`, the plain PyTorch versions (which follow the JAX
package's seal_fused_jnp / ctr_fused_jnp).  There is no fallback from CUDA
to the plain versions.  Both return new output tensors; the kernels stage
each block's rows in shared memory before writing, so they would also
allow out == in, which a later change may use to halve the stream memory.
"""
from __future__ import annotations

import torch

from ..core.bitslice import decrypt_planes, encrypt_planes, planes_to_words, words_to_planes
from . import _build
from .counter import counter_planes
from .ghash_bulk import _gf2_matmul_i8, planes_to_bits_i8, unpack_level1

# Word-axis alignment of the fused stream, the port's one place for it.
# The kernels mask their ragged edge, so any alignment works; 8 keeps the
# port's stream shapes equal to the JAX package's off-TPU shapes, which the
# parity tests compare directly.  The GCM tag does not depend on it.
SEAL_WORD_ALIGN = 8

_WORD_DTYPES = (torch.int32, torch.uint32)
_KP_SHAPES = ((11 * 128, 1), (13 * 128, 1), (15 * 128, 1))
_M32 = 0xFFFFFFFF


def _stream_to_kwords(x: torch.Tensor) -> torch.Tensor:
    """int32[W, 128] w-major stream -> [4, 32W] word-major
    (words[k, 32w+j] = x[w, 4j+k])."""
    w = x.shape[0]
    return x.reshape(w, 32, 4).permute(2, 0, 1).reshape(4, 32 * w)


def _kwords_to_stream(words: torch.Tensor) -> torch.Tensor:
    """Inverse of _stream_to_kwords."""
    w = words.shape[-1] // 32
    return words.reshape(4, w, 32).permute(1, 2, 0).reshape(w, 128)


def _ctr_keystream(kp_flat, j0c, lohi):
    rounds = kp_flat.shape[0] // 128 - 1
    w = lohi.shape[-1]
    ctr = counter_planes(j0c, lohi).reshape(8, 16, w)
    return encrypt_planes(kp_flat.reshape(rounds + 1, 8, 16), ctr)


def seal_fused_plain(kp_flat, j0c, lohi, ghmask, w1p, pt_words,
                     bits_from_input: bool = False):
    """Plain PyTorch version of seal_fused (same contract)."""
    i32 = torch.int32
    kp_flat, j0c, lohi = kp_flat.view(i32), j0c.view(i32), lohi.view(i32)
    pt = pt_words.view(i32)
    ks = _ctr_keystream(kp_flat, j0c, lohi)
    in_planes = words_to_planes(_stream_to_kwords(pt))
    out_planes = in_planes ^ ks
    ct_planes = in_planes if bits_from_input else out_planes
    ctw = _kwords_to_stream(planes_to_words(out_planes))
    return ctw.view(pt_words.dtype), level1_plain(ct_planes, ghmask, w1p)


def level1_plain(planes, ghmask, w1p):
    """The masked level-1 GHASH/POLYVAL partials of int32 planes [8, 16, W]:
    mask the positions whose bit of ghmask [1, W] is clear, fold each
    32-block row against W1 (w1p packed) -> s1 int8[128, W]."""
    w = planes.shape[-1]
    bits = planes_to_bits_i8(planes)  # [32w, 128], row n = 32w'+j
    lanes = torch.arange(32, dtype=torch.int32, device=planes.device)
    mask = (ghmask.view(torch.int32)[0][:, None] >> lanes) & 1
    bits = bits * mask.reshape(32 * w, 1).to(torch.int8)
    s1 = _gf2_matmul_i8(bits.reshape(w, 32 * 128), unpack_level1(w1p).T)
    return s1.T.to(torch.int8).contiguous()


def ctr_fused_plain(kp_flat, j0c, lohi, pt_words):
    """Plain PyTorch version of ctr_fused (same contract)."""
    i32 = torch.int32
    ks = _ctr_keystream(kp_flat.view(i32), j0c.view(i32), lohi.view(i32))
    in_planes = words_to_planes(_stream_to_kwords(pt_words.view(i32)))
    return _kwords_to_stream(planes_to_words(in_planes ^ ks)).view(pt_words.dtype)


def ctrw_fused_plain(kp_flat, ctr_words, pt_words, decrypt: bool = False):
    """C_K(ctr_words) ^ pt_words (C_K = E_K, or D_K with decrypt=True): the
    plain version of K8 ctrw_fused (ops/xex_kernels) and the cipher-and-xor
    body of the K5, K6 and K7 plain versions."""
    i32 = torch.int32
    rounds = kp_flat.shape[0] // 128 - 1
    cipher = decrypt_planes if decrypt else encrypt_planes
    ks = cipher(kp_flat.view(i32).reshape(rounds + 1, 8, 16),
                words_to_planes(_stream_to_kwords(ctr_words.view(i32))))
    in_planes = words_to_planes(_stream_to_kwords(pt_words.view(i32)))
    return _kwords_to_stream(planes_to_words(in_planes ^ ks)).view(pt_words.dtype)


def _check_words(name, **tensors):
    dev = next(iter(tensors.values())).device
    for arg, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {dev}")
        if t.dtype not in _WORD_DTYPES:
            raise TypeError(f"{name}: {arg} must be int32 or uint32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _device(name, x):
    """The device of a kernel's stream: CPU (the plain version) or CUDA."""
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev


def _check_common(name, kp_flat, j0c, lohi, pt_words):
    w = lohi.shape[-1]
    if kp_flat.shape not in _KP_SHAPES:
        raise ValueError(f"{name}: kp_flat shape {tuple(kp_flat.shape)}")
    if j0c.shape != (128, 1):
        raise ValueError(f"{name}: j0c shape {tuple(j0c.shape)}")
    if lohi.shape != (2, w):
        raise ValueError(f"{name}: lohi shape {tuple(lohi.shape)}")
    if pt_words.shape != (w, 128):
        raise ValueError(f"{name}: stream shape {tuple(pt_words.shape)}, W={w}")
    if pt_words.data_ptr() % 16:
        raise ValueError(f"{name}: stream must be 16-byte aligned")


def seal_fused(kp_flat, j0c, lohi, ghmask, w1p, pt_words,
               bits_from_input: bool = False):
    """kp_flat [(R+1)*128, 1], j0c [128, 1], lohi [2, W] (per-row 32-aligned
    counter and 24-bit extension), ghmask [1, W] (bit j of word w set =
    stream position 32w+j is a message block), w1p [128, 128] (the
    plane-ordered level-1 GHASH table packed by lane, the per-key
    ghash_bulk.pack_level1 in the tables), pt_words [W, 128] ->
    (out_words [W, 128], s1 int8[128, W]) where s1[:, w] is the level-1
    GHASH partial of 32-block chunk w.  bits_from_input=True gives the GCM
    open direction (the input is the ciphertext)."""
    dev = pt_words.device
    if dev.type == "cpu":
        return seal_fused_plain(kp_flat, j0c, lohi, ghmask, w1p, pt_words,
                                bits_from_input)
    if dev.type != "cuda":
        raise ValueError(f"seal_fused: no kernel for device {dev}")
    _check_words("seal_fused", pt_words=pt_words, kp_flat=kp_flat, j0c=j0c,
                 lohi=lohi, ghmask=ghmask, w1p=w1p)
    _check_common("seal_fused", kp_flat, j0c, lohi, pt_words)
    w = lohi.shape[-1]
    if ghmask.shape != (1, w):
        raise ValueError(f"seal_fused: ghmask shape {tuple(ghmask.shape)}")
    if w1p.shape != (128, 128):
        raise ValueError(f"seal_fused: w1p shape {tuple(w1p.shape)}")
    if w1p.data_ptr() % 16:
        raise ValueError("seal_fused: w1p must be 16-byte aligned")
    out = torch.empty_like(pt_words)
    s1 = torch.empty((128, w), dtype=torch.int8, device=dev)
    if w == 0:
        return out, s1
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.micro_aes_seal_fused(
            kp_flat.data_ptr(), j0c.data_ptr(), lohi.data_ptr(),
            ghmask.data_ptr(), w1p.data_ptr(), pt_words.data_ptr(),
            out.data_ptr(), s1.data_ptr(), kp_flat.shape[0] // 128 - 1, w,
            int(bits_from_input), stream)
    _build.check_launch("seal_fused", err)
    seal_fused.launches += 1
    return out, s1


seal_fused.launches = 0


def seal_fused_t(kp_flat, j0c, lohi, ghmask, w1p, pt_t,
                 bits_from_input: bool = False):
    """seal_fused on a transposed stream: pt_t [128, W] (column w lane 4j+k
    = word k of block 32w+j) -> (out [128, W], s1).  The JAX package runs
    this layout on the TPU; here it is the same kernel between transposes."""
    out, s1 = seal_fused(kp_flat, j0c, lohi, ghmask, w1p,
                         pt_t.T.contiguous(), bits_from_input)
    return out.T.contiguous(), s1


def ctr_fused(kp_flat, j0c, lohi, pt_words):
    """Pure CTR (counter + cipher + xor; no GHASH): kp_flat, j0c and lohi as
    for seal_fused, pt_words [W, 128] -> [W, 128]."""
    dev = pt_words.device
    if dev.type == "cpu":
        return ctr_fused_plain(kp_flat, j0c, lohi, pt_words)
    if dev.type != "cuda":
        raise ValueError(f"ctr_fused: no kernel for device {dev}")
    _check_words("ctr_fused", pt_words=pt_words, kp_flat=kp_flat, j0c=j0c,
                 lohi=lohi)
    _check_common("ctr_fused", kp_flat, j0c, lohi, pt_words)
    w = lohi.shape[-1]
    out = torch.empty_like(pt_words)
    if w == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.micro_aes_ctr_fused(
            kp_flat.data_ptr(), j0c.data_ptr(), lohi.data_ptr(),
            pt_words.data_ptr(), out.data_ptr(), kp_flat.shape[0] // 128 - 1,
            w, stream)
    _build.check_launch("ctr_fused", err)
    ctr_fused.launches += 1
    return out


ctr_fused.launches = 0


def bytes_to_stream(blocks: torch.Tensor, front_pos: int, w: int) -> torch.Tensor:
    """uint8[N,16] blocks -> int32[W, 128] w-major stream with the data from
    stream position `front_pos` (bitcast, pad, reshape)."""
    n = blocks.shape[0]
    words = blocks.contiguous().view(torch.int32).reshape(4 * n)
    flat = torch.nn.functional.pad(words, (4 * front_pos, 128 * w - 4 * n - 4 * front_pos))
    return flat.reshape(w, 128)


def stream_to_bytes(stream: torch.Tensor, front_pos: int, n: int) -> torch.Tensor:
    """[W, 128] stream -> uint8[n, 16] blocks from stream position front_pos."""
    flat = stream.reshape(-1)[4 * front_pos: 4 * front_pos + 4 * n]
    return flat.contiguous().view(torch.uint8).reshape(n, 16)
