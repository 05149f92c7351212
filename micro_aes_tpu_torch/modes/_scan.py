"""Serial-chain scans: CBC and CFB encrypt and the OFB keystream.

Within one message these chains are strictly serial (micro_aes.c:712-717,
808-814, 872-876), so each is a loop over the block axis; batching across
messages is where the parallelism is.

  * The per-message scans run the byte cipher of core/cipher, one block per
    step (the JAX package's `lax.scan` forms).
  * The packed scans hold a batch of B = 32W messages as lane-packed bit
    planes (32 messages per int32 word, a key per lane: kpw from
    core/bitslice.key_planes_packed) and run one bitsliced cipher over the
    whole batch per step.  They are the plain versions of the chain kernel
    K13 (ops/chain_kernels) and follow the JAX package's *_scan_packed.

All run on the device of their inputs.
"""
from __future__ import annotations

import torch

from ..core.bitslice import encrypt_planes_multikey, pack_planes, unpack_planes
from ..core.cipher import encrypt_blocks


def _scan(step, iv: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    ys, carry = [], iv
    for x in blocks:
        carry = step(carry, x)
        ys.append(carry)
    return torch.stack(ys) if ys else blocks.clone()


def cbc_encrypt_scan(round_keys, iv, blocks):
    """y_i = E(iv ^ x_i); iv = y_i (micro_aes.c:712-717): round_keys
    uint8[R+1,16], iv uint8[16], blocks uint8[N,16] -> uint8[N,16]."""
    return _scan(lambda c, x: encrypt_blocks(round_keys, c ^ x), iv, blocks)


def cfb_encrypt_scan(round_keys, iv, blocks):
    """y_i = E(iv) ^ x_i; iv = y_i (micro_aes.c:808-814, mode=1)."""
    return _scan(lambda c, x: encrypt_blocks(round_keys, c) ^ x, iv, blocks)


def ofb_keystream_scan(round_keys, iv, nblocks: int):
    """iv_{i+1} = E(iv_i), the nblocks keystream blocks (micro_aes.c:
    872-876) -> uint8[nblocks,16]."""
    dummy = torch.zeros((nblocks, 16), dtype=torch.uint8, device=iv.device)
    return _scan(lambda c, _: encrypt_blocks(round_keys, c), iv, dummy)


def pack_steps(blocks: torch.Tensor) -> torch.Tensor:
    """uint8[B,nb,16] -> int32[nb,8,16,W]: the planes of every step's B
    blocks, packed in one pass."""
    b, nb = blocks.shape[0], blocks.shape[1]
    planes = pack_planes(blocks.transpose(0, 1).reshape(nb * b, 16))
    return planes.reshape(8, 16, nb, b // 32).permute(2, 0, 1, 3)


def _unpack_steps(planes: list[torch.Tensor], b: int, device) -> torch.Tensor:
    """A list of nb int32[8,16,W] planes -> uint8[B,nb,16]."""
    if not planes:
        return torch.zeros((b, 0, 16), dtype=torch.uint8, device=device)
    stacked = torch.stack(planes, dim=2).reshape(8, 16, -1)  # word t*W + w
    return unpack_planes(stacked, len(planes) * b).reshape(len(planes), b, 16).transpose(0, 1)


def _scan_packed(step, ivs: torch.Tensor, xs) -> torch.Tensor:
    carry, ys = pack_planes(ivs), []
    for x in xs:
        carry = step(carry, x)
        ys.append(carry)
    return _unpack_steps(ys, ivs.shape[0], ivs.device)


def cbc_encrypt_scan_packed(kpw, ivs, blocks):
    """Batch-bitsliced CBC chains: kpw int32[R+1,8,16,W], ivs uint8[B,16],
    blocks uint8[B,nb,16], B = 32W -> uint8[B,nb,16]."""
    return _scan_packed(lambda c, x: encrypt_planes_multikey(kpw, c ^ x), ivs,
                        pack_steps(blocks))


def cfb_encrypt_scan_packed(kpw, ivs, blocks):
    """Batch-bitsliced CFB encrypt chains (y = E(carry) ^ x; carry = y)."""
    return _scan_packed(lambda c, x: encrypt_planes_multikey(kpw, c) ^ x, ivs,
                        pack_steps(blocks))


def ofb_keystream_scan_packed(kpw, ivs, nblocks: int):
    """Batch-bitsliced OFB keystreams (iv_{i+1} = E(iv_i)) ->
    uint8[B,nblocks,16]."""
    return _scan_packed(lambda c, _: encrypt_planes_multikey(kpw, c), ivs, range(nblocks))
