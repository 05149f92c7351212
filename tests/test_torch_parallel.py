"""The port's sharded paths (micro_aes_tpu_torch.parallel) on a gloo world of
4 CPU ranks, against the port's unsharded paths and the JAX package.

One world is spawned for the whole file (tests/_torch_dist_world.py: a
FileStore under tmp_path, a 60 s timeout); meshes of 1 and 2 ranks are its
first ranks, the rest sit out.  The sp-sharded GCM runs at meshes (1,1),
(1,2), (1,4) and (2,2), both ways, with and without AAD; each dp twin at dp
= 1, 2 and 4.  The assembled results must equal the port's unsharded paths
bit for bit, and a message of each against the JAX package's per-message
API.  The host-side pieces (the adjust matrices, the AAD arguments, the
blocks-form seal at a shard's counter offset, the matrix-GHASH core) are
held against the JAX package's, its side eager under jax.disable_jit; no
JAX shard_map function is compiled.
"""
import functools
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import micro_aes_tpu.modes as jmodes
import micro_aes_tpu.modes.seal as jseal
import micro_aes_tpu.modes.seal_batch as jsb
import micro_aes_tpu.ops.pallas_seal as jps
import micro_aes_tpu.parallel.sharded as jsh

import _torch_dist_world as worldmod
import micro_aes_tpu_torch.modes.seal as tseal
import micro_aes_tpu_torch.modes.seal_batch as tsb
from micro_aes_tpu_torch import parallel as par
from micro_aes_tpu_torch.core.bitslice import key_planes_packed
from micro_aes_tpu_torch.modes import bulk
from micro_aes_tpu_torch.modes.ccm import _iv0
from micro_aes_tpu_torch.modes.xts_bulk import xts_seal_sectors
from micro_aes_tpu_torch.ops.aead_kernels import aead_chain_fused
from micro_aes_tpu_torch.ops.chain_kernels import chain_packed_fused, ofb_packed_fused
from micro_aes_tpu_torch.ops.ghash_bulk import pack_level1
from micro_aes_tpu_torch.ops.mac import cbcmac_fold_batch_auto, ghash_fold_batch
from micro_aes_tpu_torch.ops.multikey import ctrw_fused_multikey_plain
from micro_aes_tpu_torch.ops.seal_kernels import seal_fused_plain

CPU = "cpu"
WORLD = 4
GCM_BLOCKS = 128   # shards of 128, 64 and 32 blocks
GCM_MESHES = ((1, 1), (1, 2), (1, 4), (2, 2))
DPS = (1, 2, 4)


def _rng(seed):
    return np.random.default_rng(seed)


def _rand(rng, *shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


# -- the world ---------------------------------------------------------------

class World:
    def __init__(self, tasks, results):
        self.tasks, self.results = tasks, results

    def run(self, name, dp, sp, payload=None):
        """Every rank runs the task -> [(coords, result)] of the mesh's ranks."""
        for q in self.tasks:
            q.put((name, dp, sp, payload))
        answers = [self.results.get(timeout=120) for _ in range(WORLD)]
        errors = [a[2] for a in answers if a[1] != "ok"]
        assert not errors, errors[0]
        return [a[2] for a in sorted(answers) if a[2] is not None]


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """The ranks start with the module (autouse) and come up while the
    host-side tests, first in the file, run."""
    ctx = multiprocessing.get_context("spawn")
    store = str(tmp_path_factory.mktemp("gloo") / "store")
    tasks = [ctx.Queue() for _ in range(WORLD)]
    results = ctx.Queue()
    procs = [ctx.Process(target=worldmod.serve, args=(r, WORLD, store, tasks[r], results),
                         daemon=True) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        yield World(tasks, results)
    finally:
        for q in tasks:
            q.put(None)
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()


def _by_dp(answers, dp):
    """A dp twin's per-rank results, concatenated in dp order."""
    parts = sorted((c[0], r) for c, r in answers)
    assert [d for d, _ in parts] == list(range(dp))
    first = parts[0][1]
    if isinstance(first, tuple):
        return tuple(np.concatenate([r[i] for _, r in parts]) for i in range(len(first)))
    return np.concatenate([r for _, r in parts])


# -- host-side pieces against the JAX package -------------------------------------

def test_solo_mesh_without_a_process_group():
    assert not dist.is_initialized()
    mesh = par.make_mesh(1, 1, device=CPU)
    assert mesh.shape == {"dp": 1, "sp": 1} and mesh.coords == (0, 0)
    assert mesh.sp_group is None and mesh.device == torch.device(CPU)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        par.make_mesh(1, 2, device=CPU)
    par.init_distributed(device=CPU)   # no cluster environment: a no-op
    assert not dist.is_initialized()
    bits = torch.tensor([[0, 1, 3]])
    assert par.xor_allreduce(bits, mesh.sp_group).tolist() == [[0, 1, 1]]
    assert (par.backend_for("cuda"), par.backend_for(CPU)) == ("nccl", "gloo")
    assert par.host_local_batch(mesh, np.arange(6)).tolist() == list(range(6))
    with pytest.raises(ValueError):   # nothing runs off the mesh's device
        par.gcm_seal_sharded_fused_fn(mesh, 32)(*(torch.zeros(1, device="meta"),) * 6)


@pytest.mark.parametrize("shards", (1, 2, 4))
def test_shard_adjust_matrices_match_jax(shards):
    _, tables = tseal.gcm_key_setup(bytes(range(16)), device=CPU)
    _, jtables = jseal.gcm_key_setup(bytes(range(16)))
    assert np.array_equal(par.shard_adjust_matrices(tables[3], 64, shards, device=CPU).numpy(),
                          np.asarray(jsh.shard_adjust_matrices(jtables[3], 64, shards)))
    got = par.shard_adjust_matrices_fused(tables[3], 64, shards, device=CPU)
    assert np.array_equal(got.numpy(),
                          np.asarray(jsh.shard_adjust_matrices_fused(jtables[3], 64, shards)))
    with pytest.raises(ValueError):
        par.shard_adjust_matrices_fused(tables[3], 64, shards, chunk2=2, device=CPU)


@pytest.mark.parametrize("aad", (b"", bytes(range(40))), ids=("no-aad", "aad"))
def test_sharded_aad_args_match_jax(aad):
    key = bytes(range(32))
    with jax.disable_jit():
        want = jsh.sharded_aad_args(key, aad, 96, 3)
    got = par.sharded_aad_args(key, aad, 96, 3, device=CPU)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1])) and got[2] == want[2]


def _jax_state(key):
    jkp, jtables = jseal.gcm_key_setup(key)
    return jkp, jtables, tseal.gcm_key_setup(key, device=CPU)


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.uint32).view(np.int32).copy())


@pytest.fixture
def jax_k1_is_the_ports(monkeypatch):
    """The JAX seal body's K1 (seal_fused_auto) as the port's plain version,
    which tests/test_torch_seal.py holds against JAX's twin: the JAX body's
    counter operands (the shard offset) and GHASH levels stay JAX's, and its
    eager run skips the twin's cipher."""
    def k1(kp_flat, j0c, lohi, ghmask, w1t, pt, bits_from_input=False):
        out, s1 = seal_fused_plain(*map(_i32, (kp_flat, j0c, lohi, ghmask)),
                                   torch.from_numpy(pack_level1(np.asarray(w1t).T)), _i32(pt),
                                   bits_from_input)
        return jnp.asarray(out.numpy().view(np.uint32)), jnp.asarray(s1.numpy())

    monkeypatch.setattr(jps, "seal_fused_auto", k1)


@pytest.mark.parametrize("start", (-1, 31))
def test_fused_seal_body_matches_jax(start, jax_k1_is_the_ports):
    """The blocks-form body at a whole message's offset and at a shard's
    (start = s*L - 1 with L = 32): stream out, E(J0+1+start), GHASH partial."""
    rng = _rng(start + 2)
    key = _rand(rng, 32).tobytes()
    jkp, jtables, (kp, tables) = _jax_state(key)
    j0 = worldmod._j0([_rand(rng, 12).tobytes()])[0]
    pt = _rand(rng, 64, 16)
    with jax.disable_jit():
        want = jseal.fused_seal_body(jkp, jtables, jnp.asarray(j0), jnp.asarray(pt), False, start)
    got = tseal.fused_seal_body(kp, tables, torch.from_numpy(j0), torch.from_numpy(pt), False,
                                start)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_gcm_seal_kernel_fused_matches_jax_and_gcm_seal(jax_k1_is_the_ports):
    rng = _rng(5)
    key, nonce, aad = _rand(rng, 16).tobytes(), _rand(rng, 12).tobytes(), b"blocks-form AAD"
    jkp, jtables, (kp, tables) = _jax_state(key)
    j0 = worldmod._j0([nonce])[0]
    pt = _rand(rng, 40, 16)
    ab, alen, shift = tseal._aad_prep(key, aad, 40, torch.device(CPU))
    adj = tseal._trail_adjust_t(key, tseal.fused_trailing_pad(40), torch.device(CPU))
    ct, tag = tseal.gcm_seal_kernel_fused(kp, tables, adj, torch.from_numpy(j0),
                                          torch.from_numpy(pt), False, ab, alen, shift)
    with jax.disable_jit():
        jct, jtag = jseal.gcm_seal_kernel_fused(
            jkp, jtables, jseal._trail_adjust_t(key, jseal.fused_trailing_pad(40)),
            jnp.asarray(j0), jnp.asarray(pt), False, jnp.asarray(ab.numpy()), alen,
            jseal._aad_shift_t(key, 40))
    assert np.array_equal(ct.numpy(), np.asarray(jct)) and np.array_equal(tag.numpy(),
                                                                         np.asarray(jtag))
    sealed = ct.numpy().tobytes() + tag.numpy().tobytes()
    assert sealed == tseal.gcm_seal(key, nonce, pt.tobytes(), aad, device=CPU)


def test_seal_batch_core_matches_jax(monkeypatch):
    """The matrix-GHASH core: the prep equal; the tables equal JAX's jitted
    _derive_tables, and the cold core the warm one; JAX's core body, run
    eagerly on its own tables and the same cipher output (K9's plain
    version, held against JAX's K9 in tests/test_torch_mk_aead.py), returns
    the port's stream and tags; the tags are GCM's."""
    rng = _rng(9)
    keys = [_rand(rng, 16).tobytes() for _ in range(2)]
    nonces = [_rand(rng, 12).tobytes() for _ in range(2)]
    aads, pts = [b"", b"aad"], [_rand(rng, 32).tobytes(), _rand(rng, 64).tobytes()]
    jp = jsb._prep(keys, nonces, aads, pts)
    tp = tsb._prep(keys, nonces, aads, pts, device=CPU)
    assert jp[:2] == tp[:2] and np.array_equal(jp[4], tp[4])
    for j, t in zip(jp[5:], tp[5:]):
        t = t.numpy().view(np.uint32) if t.dtype == torch.int32 else t.numpy()
        assert np.array_equal(np.asarray(j).reshape(t.shape), t)
    b, wm = tp[0], tp[1]
    out, tags = tsb._seal_batch_core(*tp[5:], b, wm)
    h = out.numpy().reshape(b, wm, 128)[:, 0, 0:4].copy().view(np.uint8).reshape(b, 16)
    tables = tsb._tables_cached(b"".join(keys), 16, torch.device(CPU))
    jtables = jsb._derive_tables(jnp.asarray(h))
    for j, t in zip(jtables, tables):
        assert np.array_equal(np.asarray(j), t.numpy())
    warm = tsb._seal_batch_core_warm(*tp[5:], tables, b, wm)
    assert torch.equal(warm[0], out) and torch.equal(warm[1], tags)

    def cipher(kp_stack, ctrw, ptw, nb):
        got = ctrw_fused_multikey_plain(*map(_i32, (kp_stack, ctrw, ptw)), nb)
        return jnp.asarray(got.numpy().view(np.uint32))

    monkeypatch.setattr(jsb, "ctrw_fused_multikey_auto", cipher)
    with jax.disable_jit():
        jout, jtags = jsb._seal_body(*jp[5:], b, wm, tables=jtables)
    assert np.array_equal(out.numpy().view(np.uint32), np.asarray(jout))
    assert np.array_equal(tags.numpy(), np.asarray(jtags))
    words = out.numpy().view(np.uint32).reshape(b, -1)
    f, n = tp[4][1], len(pts[1]) // 16
    assert words[1, 4 * f: 4 * (f + n)].tobytes() + tags[1].numpy().tobytes() == \
        jmodes.gcm_encrypt(keys[1], nonces[1], aads[1], pts[1])


# -- the sp-sharded GCM -------------------------------------------------------

def _gcm_case(seed, aad):
    rng = _rng(seed)
    key = _rand(rng, 32).tobytes()
    nonces = [_rand(rng, 12).tobytes() for _ in range(2)]
    pts = _rand(rng, 2, GCM_BLOCKS, 16)
    sealed = [tseal.gcm_seal(key, n, p.tobytes(), aad, device=CPU) for n, p in zip(nonces, pts)]
    return key, nonces, pts, sealed


def _assemble_gcm(answers, dp, sp):
    """Outputs [B, N, 16] from the (dp, sp) slices; the tags, which every
    rank of an sp group must agree on."""
    l = GCM_BLOCKS // sp
    bl = 2 // dp
    out = np.zeros((2, GCM_BLOCKS, 16), np.uint8)
    tags = {}
    for (d, s), (o, t) in answers:
        out[d * bl:(d + 1) * bl, s * l:(s + 1) * l] = o
        for i in range(bl):
            tags.setdefault(d * bl + i, set()).add(t[i].tobytes())
    assert len(answers) == dp * sp and all(len(v) == 1 for v in tags.values())
    return out, [tags[i].pop() for i in range(2)]


@pytest.mark.parametrize("direction", ("seal", "open"))
@pytest.mark.parametrize("aad", (b"", b"sharded AAD, 21 B"), ids=("no-aad", "aad"))
@pytest.mark.parametrize("mesh", GCM_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_fused_gcm(world, mesh, aad, direction):
    dp, sp = mesh
    key, nonces, pts, sealed = _gcm_case(sum(mesh) + len(aad), aad)
    cts = np.stack([np.frombuffer(s[:-16], np.uint8).reshape(GCM_BLOCKS, 16) for s in sealed])
    opening = direction == "open"
    payload = {"key": key, "nonces": nonces, "aad": aad, "data": cts if opening else pts,
               "open": opening}
    out, tags = _assemble_gcm(world.run("gcm_fused", dp, sp, payload), dp, sp)
    assert np.array_equal(out, pts if opening else cts)
    assert tags == [s[-16:] for s in sealed]
    if not opening:
        assert sealed[0] == jmodes.gcm_encrypt(key, nonces[0], aad, pts[0].tobytes())


def test_sharded_k2_gcm(world):
    key, nonces, pts, sealed = _gcm_case(7, b"")
    out, tags = _assemble_gcm(world.run("gcm_k2", 1, 2, {"key": key, "nonces": nonces,
                                                         "data": pts}), 1, 2)
    assert [o.tobytes() + t for o, t in zip(out, tags)] == sealed
    assert sealed[1] == jmodes.gcm_encrypt(key, nonces[1], b"", pts[1].tobytes())


def test_mesh_of_the_world(world):
    """Rank r of a (dp, sp) mesh sits at (r // sp, r % sp); ranks past the
    grid get none; a grid larger than the world raises."""
    assert [c for c, _ in world.run("mesh", 2, 2)] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    answers = world.run("mesh", 1, 2)
    assert [c for c, _ in answers] == [(0, 0), (0, 1)]
    assert answers[0][1] == "need 8 devices, have 4"


# -- the dp twins ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _twin_case(name):
    """(task, payload, unsharded result, check of the assembled result)."""
    rng = _rng(len(name))
    if name == "seal_batch":
        keys = [_rand(rng, 16).tobytes() for _ in range(4)]
        nonces = [_rand(rng, 12).tobytes() for _ in range(4)]
        aads = [b"tenant-%d" % i for i in range(4)]
        pts = [_rand(rng, 32 * (i % 3 + 1)).tobytes() for i in range(4)]
        b, wm, _, ns, front, *args = tsb._prep(keys, nonces, aads, pts, device=CPU)
        names = ("kp_stack", "j0w", "front", "mask", "sel", "len_bits", "ptw")
        want = tsb._seal_batch_core(*args, b, wm)
        api = tsb.gcm_seal_batch(keys, nonces, aads, pts, device=CPU)
        assert api[0] == jmodes.gcm_encrypt(keys[0], nonces[0], aads[0], pts[0])

        def check(out, tags):
            words = out.view(np.uint32).reshape(b, -1)
            got = [words[i, 4 * front[i]: 4 * (front[i] + ns[i])].tobytes() + tags[i].tobytes()
                   for i in range(b)]
            assert got == api
        payload = {"b": b, "wm": wm, "split": dict(zip(names, (a.numpy() for a in args)))}
        return "seal_batch", payload, want, check
    if name in ("xts", "xts_open"):
        keys = _rand(rng, 32).tobytes()
        ids = list(range(7000, 7004))
        data = _rand(rng, 4 * 512).tobytes()
        ct = xts_seal_sectors(keys, ids, data, 512, device=CPU)
        assert ct[:512] == jmodes.xts_encrypt(keys, ids[0].to_bytes(16, "little"), data[:512])
        tweaks = np.zeros((4, 16), np.uint8)
        tweaks[:, :8] = np.array(ids, "<u8").view(np.uint8).reshape(4, 8)
        opening = name == "xts_open"
        src, dst = (ct, data) if opening else (data, ct)
        payload = {"keys": keys, "r": 1, "decrypt": opening,
                   "split": {"tweaks": tweaks, "ptw": tseal.host_stream(src, 0, 4)}}

        def check(out):
            assert out.tobytes() == dst
        return "xts", payload, None, check
    if name in ("cbc", "cfb", "ofb"):
        b, nb = 128, 2
        keys = [_rand(rng, 16).tobytes() for _ in range(b)]
        kpw = key_planes_packed(bulk.stack_round_keys(keys))
        ivs, blocks = _rand(rng, b, 16), _rand(rng, b, nb, 16)
        kpw_t, ivs_t = torch.from_numpy(kpw.view(np.int32)), torch.from_numpy(ivs)
        if name == "ofb":
            want = ofb_packed_fused(kpw_t, ivs_t, nb).numpy()
            jax_one = jmodes.ofb_encrypt(keys[5], ivs[5].tobytes(), bytes(nb * 16))
        else:
            want = chain_packed_fused(name, kpw_t, ivs_t, torch.from_numpy(blocks)).numpy()
            enc = jmodes.cbc_encrypt if name == "cbc" else jmodes.cfb_encrypt
            kw = {"cts": False} if name == "cbc" else {}
            jax_one = enc(keys[5], ivs[5].tobytes(), blocks[5].tobytes(), **kw)
        assert want[5].tobytes() == jax_one
        payload = {"kind": name, "nb": nb, "whole": {"kpw": kpw.view(np.int32)},
                   "split": {"ivs": ivs, "blocks": blocks}}
        return "chain", payload, want, None
    if name == "ccm":
        keys = [_rand(rng, 16).tobytes() for _ in range(4)]
        nonces = [_rand(rng, 11).tobytes() for _ in range(4)]
        aads = [b"shard-aad-%d" % i for i in range(4)]
        pts = [_rand(rng, 48).tobytes() for _ in range(4)]
        rks = bulk.stack_round_keys(keys)
        iv0s = np.stack([_iv0(n) for n in nonces])
        pb, nv1 = bulk._ccm_prefix_batch(iv0s, [np.frombuffer(a, np.uint8) for a in aads],
                                         [48] * 4, 16)
        init = cbcmac_fold_batch_auto(rks, torch.zeros((4, 16), dtype=torch.uint8),
                                      torch.from_numpy(pb), nv1).numpy()
        api = bulk.ccm_encrypt_batch(keys, nonces, aads, pts, device=CPU)
        assert api[2] == jmodes.ccm_encrypt(keys[2], nonces[2], aads[2], pts[2])
        split = {"rks": rks, "c0": iv0s, "init": init,
                 "blocks": np.frombuffer(b"".join(pts), np.uint8).reshape(4, 3, 16),
                 "nvalid": np.full(4, 3, np.int32), "tail": np.full((4, 16), 0xFF, np.uint8),
                 "lastadd": np.zeros((4, 16), np.uint8)}

        def check(out, tags):
            assert [o.tobytes() + t.tobytes() for o, t in zip(out, tags)] == api
        return "aead", {"kind": "ccm", "decrypt": False, "split": split}, None, check
    if name == "eax":  # the open direction, on random operands, against one unsharded call
        split = {"rks": bulk.stack_round_keys([_rand(rng, 16).tobytes() for _ in range(4)]),
                 "c0": _rand(rng, 4, 16), "init": _rand(rng, 4, 16),
                 "blocks": _rand(rng, 4, 3, 16), "nvalid": np.array([0, 1, 3, 2], np.int32),
                 "tail": _rand(rng, 4, 16), "lastadd": _rand(rng, 4, 16)}
        t = {k: torch.from_numpy(v) for k, v in split.items()}
        want = aead_chain_fused("eax", bulk._lane_keys(split["rks"], 28, CPU),
                                *(bulk._rows(t[k], 28, CPU) for k in (
                                    "c0", "init", "blocks", "nvalid", "tail", "lastadd")),
                                decrypt=True)
        return "aead", {"kind": "eax", "decrypt": True, "split": split}, \
            tuple(w[:4].numpy() for w in want), None
    if name == "gcm_chain":
        keys = [_rand(rng, 16).tobytes() for _ in range(4)]
        nonces = [_rand(rng, 12).tobytes() for _ in range(4)]
        aads = [b"tenant-%d" % i for i in range(4)]
        ns = [1, 2, 3, 4]
        pts = [_rand(rng, 16 * n).tobytes() for n in ns]
        rks = bulk.stack_round_keys(keys)
        j0 = worldmod._j0(nonces)
        rks_t = torch.from_numpy(rks)
        h = bulk._enc1_batch(rks_t, torch.zeros((4, 16), dtype=torch.uint8))
        ej0 = bulk._enc1_batch(rks_t, torch.from_numpy(j0)).numpy()
        c0 = j0.copy()
        c0[:, 15] = 2
        blocks = np.zeros((4, 4, 16), np.uint8)
        lenb = np.zeros((4, 16), np.uint8)
        aadb = np.zeros((4, 1, 16), np.uint8)
        for i in range(4):
            blocks[i, : ns[i]] = np.frombuffer(pts[i], np.uint8).reshape(ns[i], 16)
            aadb[i, 0, : len(aads[i])] = np.frombuffer(aads[i], np.uint8)
            lenb[i] = np.frombuffer((8 * len(aads[i])).to_bytes(8, "big")
                                    + (128 * ns[i]).to_bytes(8, "big"), np.uint8)
        init = ghash_fold_batch(h, torch.zeros((4, 16), dtype=torch.uint8),
                                torch.from_numpy(aadb), [1] * 4).numpy()
        api = tsb.gcm_seal_batch(keys, nonces, aads, pts, device=CPU)
        assert api[3] == jmodes.gcm_encrypt(keys[3], nonces[3], aads[3], pts[3])
        split = {"rks": rks, "h": h.numpy(), "ej0": ej0, "c0": c0, "init": init,
                 "blocks": blocks, "nvalid": np.array(ns, np.int32), "lenb": lenb}

        def check(out, tags):
            assert [out[i, : ns[i]].tobytes() + tags[i].tobytes() for i in range(4)] == api
        return "gcm_chain", {"split": split}, None, check
    if name == "siv":
        keys = [_rand(rng, 32).tobytes() for _ in range(4)]
        aads = [b"hdr-%d" % i for i in range(4)]
        lens = [16 * (i % 4 + 1) + (0 if i % 2 else 5) for i in range(4)]
        pts = [_rand(rng, n).tobytes() for n in lens]
        rks1 = bulk.stack_round_keys([k[:16] for k in keys])
        rks2 = bulk.stack_round_keys([k[16:] for k in keys])
        d, q = bulk._cmac_subkeys(rks1, CPU)
        y = bulk._s2v_y(rks1, d, q, [np.frombuffer(a, np.uint8) for a in aads], CPU)
        tail, lastadd, prevadd, nv = bulk._siv_s2v_consts(d, q, y, lens)
        blocks = np.zeros((4, int(nv.max()), 16), np.uint8)
        for i, p in enumerate(pts):
            blocks[i].reshape(-1)[: len(p)] = np.frombuffer(p, np.uint8)
        api = bulk.siv_encrypt_batch(keys, aads, pts, device=CPU)
        assert api[1] == tuple(jmodes.siv_encrypt(keys[1], aads[1], pts[1]))
        split = {"rks1": rks1, "rks2": rks2, "init": np.zeros((4, 16), np.uint8),
                 "blocks": blocks, "nvalid": nv, "tail": tail, "lastadd": lastadd,
                 "prevadd": prevadd}

        def check(ct, iv):
            assert [(iv[i].tobytes(), ct[i].reshape(-1)[: n].tobytes())
                    for i, n in enumerate(lens)] == api
        return "siv", {"split": split}, None, check
    raise ValueError(name)


TWINS = ("seal_batch", "xts", "xts_open", "cbc", "cfb", "ofb", "ccm", "eax", "gcm_chain",
         "siv")


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("twin", TWINS)
def test_dp_twin(world, twin, dp):
    task, payload, want, check = _twin_case(twin)
    got = _by_dp(world.run(task, dp, 1, payload), dp)
    if want is not None:
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        for g, w in pairs:
            w = w.numpy() if torch.is_tensor(w) else w
            assert np.array_equal(g, w)
    if check is not None:
        check(*got) if isinstance(got, tuple) else check(got)
