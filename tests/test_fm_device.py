"""Device FM-index kernels vs host oracle (runs on the CPU backend)."""
import numpy as np
import jax.numpy as jnp
import pytest

from mapcaller.dna import encode
from mapcaller.index.fmindex import build_index
from mapcaller.index.packer import PackedReference
from mapcaller.ops.fm_device import DeviceFMIndex, occ4, occ_one, inv_psi, sa_resolve
from mapcaller.ops.fm_search import build_seed_kernel, seeds_to_frag_pairs
from mapcaller.pipeline.seeding import identify_simple_pairs


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, size=3000).astype(np.uint8)
    ref = PackedReference(["chr1"], [len(codes)], [0], codes, [])
    idx = build_index(None, packed=ref)
    return idx, DeviceFMIndex.from_host(idx)


def test_occ4_matches_host(pair):
    idx, fm = pair
    ks = np.array([0, 1, 5, 127, 128, 129, 1000, idx.seq_len - 1, -1], dtype=np.int32)
    got = np.asarray(occ4(fm, jnp.asarray(ks)))
    for i, k in enumerate(ks):
        want = idx.occ4(int(k)) if k >= 0 else np.zeros(4)
        assert np.array_equal(got[i], want), k


def test_occ_one_matches_host(pair):
    idx, fm = pair
    rng = np.random.default_rng(2)
    ks = rng.integers(0, idx.seq_len, size=64).astype(np.int32)
    cs = rng.integers(0, 4, size=64).astype(np.int32)
    got = np.asarray(occ_one(fm, jnp.asarray(ks), jnp.asarray(cs)))
    for i in range(64):
        assert got[i] == idx.occ(int(ks[i]), int(cs[i]))


def test_inv_psi_and_sa(pair):
    idx, fm = pair
    rng = np.random.default_rng(3)
    ks = rng.integers(1, idx.seq_len, size=64).astype(np.int32)
    got = np.asarray(inv_psi(fm, jnp.asarray(ks)))
    for i in range(64):
        assert got[i] == idx.inv_psi(int(ks[i]))
    locs, resolved = sa_resolve(fm, jnp.asarray(ks), jnp.ones(64, dtype=bool))
    locs = np.asarray(locs)
    assert np.asarray(resolved).all()
    for i in range(64):
        assert locs[i] == idx.sa_lookup(int(ks[i]))
    # walk fallback path (no full SA)
    import dataclasses as dc
    fm_nosa = dc.replace(fm, sa_full=jnp.zeros(0, dtype=jnp.int32))
    locs2, resolved2 = sa_resolve(fm_nosa, jnp.asarray(ks),
                                  jnp.ones(64, dtype=bool))
    locs2 = np.asarray(locs2)
    for i in range(64):
        if np.asarray(resolved2)[i]:
            assert locs2[i] == idx.sa_lookup(int(ks[i]))


def test_seed_kernel_matches_oracle(pair):
    idx, fm = pair
    rng = np.random.default_rng(4)
    B, MAXLEN = 32, 128
    codes = np.full((B, MAXLEN), 4, dtype=np.uint8)
    rlens = np.zeros(B, dtype=np.int32)
    for b in range(B):
        rlen = int(rng.integers(40, 120))
        p = int(rng.integers(0, idx.genome_size - rlen))
        q = idx.ref.codes[p:p + rlen].copy()
        nmut = int(rng.integers(0, 4))
        for _ in range(nmut):
            q[int(rng.integers(0, rlen))] = rng.integers(0, 5)  # incl. N
        codes[b, :rlen] = q
        rlens[b] = rlen
    kern = build_seed_kernel(fm, MAXLEN, B)
    (hit_read, hit_rpos, hit_len, hit_loc, hit_valid,
     total, overflow, buf_ovf) = (np.asarray(x) for x in
                                  kern(jnp.asarray(codes), jnp.asarray(rlens)))
    assert not buf_ovf and not overflow.any()
    got = seeds_to_frag_pairs(hit_read, hit_rpos, hit_len, hit_loc, hit_valid,
                              B, idx.seq_len)
    for b in range(B):
        want = identify_simple_pairs(idx, codes[b, :rlens[b]])
        gl = [(f.rPos, f.gPos, f.rLen) for f in got[b]]
        wl = [(f.rPos, f.gPos, f.rLen) for f in want]
        assert gl == wl, b
