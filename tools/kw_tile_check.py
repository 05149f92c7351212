#!/usr/bin/env python3
"""Checks the JAX package's K16 (ops/pallas_chain.kw_packed_fused) against
its vmapped per-message scan (modes/kw._wrap_scan) at a batch where K16's
lane tile (kw_tile) and the key order's tile (wide_perm's wide_tile)
differ: B = 8192, n = 2, AES-128, keys packed as its callers pack them,
key_planes_packed(rks[wide_perm(B)]).  Runs the Pallas kernel in interpret
mode on the CPU (a minute or two).  Prints both tiles and how many messages
agree with the scan.

    python3 tools/kw_tile_check.py
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # the repository root

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from micro_aes_tpu.core.bitslice import key_planes_packed  # noqa: E402
from micro_aes_tpu.modes.bulk import stack_round_keys  # noqa: E402
from micro_aes_tpu.modes.kw import _wrap_scan  # noqa: E402
from micro_aes_tpu.ops.pallas_chain import (  # noqa: E402
    kw_kernel_fits,
    kw_packed_fused,
    kw_tile,
    wide_perm,
    wide_tile,
)


def main() -> None:
    b, n = 8192, 2
    w = b // 32
    print(f"kw_tile {kw_tile(w, n)}, wide_tile {wide_tile(w)}, "
          f"kw_kernel_fits {kw_kernel_fits(b, n)}")
    rng = np.random.default_rng(1)
    rks = stack_round_keys([rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
                            for _ in range(b)])
    secrets = rng.integers(0, 256, (b, n, 8), dtype=np.uint8)
    got = np.asarray(kw_packed_fused(jnp.asarray(key_planes_packed(rks[wide_perm(b)])),
                                     jnp.asarray(secrets)))
    a, r = jax.vmap(lambda rk, av, rv: _wrap_scan(rk, av, rv, n))(
        jnp.asarray(rks), jnp.full((b, 8), 0xA6, jnp.uint8), jnp.asarray(secrets))
    want = np.concatenate([np.asarray(a)[:, None], np.asarray(r)], axis=1)
    agree = int(np.all(got == want, axis=(1, 2)).sum())
    print(f"messages that agree with the scan: {agree} of {b}")


if __name__ == "__main__":
    main()
