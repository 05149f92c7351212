"""Parity of the port's K14 and K15 plain versions with the JAX package, on
the CPU.

  * K14 (ops/chain_kernels chain_packed_fused_wide / ofb_packed_fused_wide):
    K13's chains in the wide message map, with keys packed from
    rks[wide_perm(B)], against the JAX package's packed scans
    (modes/_scan.*_scan_packed) on the natural key_planes_packed(rks), at
    the least B that takes the wide map.
  * K15 (ops/aead_kernels ctr_packed_fused): the lane-packed CTR against the
    JAX package's ops/counter.counter_blocks(..., "be") and its byte cipher,
    message by message, with bases that carry across 2^32 and into byte 9.

Inputs come from numpy seeds; every comparison is bit-exact.  The JAX side
runs eagerly (jax.disable_jit): nothing is compiled, and no Pallas kernel
runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import micro_aes_tpu.modes._scan as jscan
from micro_aes_tpu.core.cipher import encrypt_blocks as j_encrypt_blocks
from micro_aes_tpu.modes.bulk import stack_round_keys as j_stack_round_keys
from micro_aes_tpu.ops.counter import counter_blocks as j_counter_blocks

from micro_aes_tpu_torch.core.bitslice import key_planes_packed, wide_perm
from micro_aes_tpu_torch.ops import aead_kernels as ak
from micro_aes_tpu_torch.ops import chain_kernels as ck


def _keys(rng, b, klen):
    return j_stack_round_keys([rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
                               for _ in range(b)])


def _planes(rks) -> torch.Tensor:
    return torch.from_numpy(key_planes_packed(rks).view(np.int32))


def test_wide_chain_plain_versions_match_jax_scans():
    rng = np.random.default_rng(53)
    b, nb = 1024, 3
    rks = _keys(rng, b, 16)
    kpw = key_planes_packed(rks)
    kpw_w = _planes(rks[wide_perm(b)])
    ivs = rng.integers(0, 256, (b, 16), dtype=np.uint8)
    blocks = rng.integers(0, 256, (b, nb, 16), dtype=np.uint8)
    iv_t, blocks_t = torch.from_numpy(ivs), torch.from_numpy(blocks)
    with jax.disable_jit():
        want = {"cbc": jscan.cbc_encrypt_scan_packed(kpw, jnp.asarray(ivs), jnp.asarray(blocks)),
                "cfb": jscan.cfb_encrypt_scan_packed(kpw, jnp.asarray(ivs), jnp.asarray(blocks)),
                "ofb": jscan.ofb_keystream_scan_packed(kpw, jnp.asarray(ivs),
                                                       jnp.zeros(nb, jnp.uint8))}
    for kind in ("cbc", "cfb"):
        got = ck.chain_packed_fused_wide(kind, kpw_w, iv_t, blocks_t)
        assert np.array_equal(got.numpy(), np.asarray(want[kind])), kind
    got = ck.ofb_packed_fused_wide(kpw_w, iv_t, nb)
    assert np.array_equal(got.numpy(), np.asarray(want["ofb"]))


def test_wide_chain_needs_wide_ok():
    kpw = torch.zeros((11, 8, 16, 31), dtype=torch.int32)
    ivs, blocks = torch.zeros((992, 16), dtype=torch.uint8), torch.zeros((992, 1, 16),
                                                                          dtype=torch.uint8)
    with pytest.raises(ValueError):
        ck.chain_packed_fused_wide("cbc", kpw, ivs, blocks)
    with pytest.raises(ValueError):
        ck.ofb_packed_fused_wide(kpw, ivs, 1)


@pytest.mark.parametrize("klen", (16, 32))
def test_ctr_packed_plain_version_matches_jax(klen):
    rng = np.random.default_rng(61 + klen)
    b, nb = 32, 3
    rks = _keys(rng, b, klen)
    c0 = rng.integers(0, 256, (b, 16), dtype=np.uint8)
    c0[0, 9:] = 0xFF     # the 56-bit window wraps at step 1, byte 8 untouched
    c0[1, 12:] = 0xFF    # a carry across 2^32 into byte 11 at step 1
    c0[2, 9:] = 0xFF
    c0[2, 15] = 0xFE     # a carry through bytes 9..11 at step 2
    blocks = rng.integers(0, 256, (b, nb, 16), dtype=np.uint8)
    blocks[3] = 0        # zeros give the raw keystream
    got = ak.ctr_packed_fused(_planes(rks), torch.from_numpy(c0), torch.from_numpy(blocks))
    with jax.disable_jit():
        ctrs = jnp.stack([j_counter_blocks(jnp.asarray(c0[m]), nb, 0, "be") for m in range(b)])
        # the byte cipher with a key per message: round keys [R+1,B,1,16]
        # broadcast against the counters [B,nb,16]
        rk = jnp.asarray(rks.transpose(1, 0, 2)[:, :, None, :])
        want = np.asarray(j_encrypt_blocks(rk, ctrs)) ^ blocks
    assert np.array_equal(got.numpy(), want)
    wrapped = np.asarray(ctrs[0, 1])
    assert wrapped[8] == c0[0, 8] and not wrapped[9:].any()
