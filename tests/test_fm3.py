"""3-step occ table + derived 1-step lookups + the occ3 seed kernel vs
host oracles (runs on the CPU backend)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mapcaller.index.fmindex import build_index
from mapcaller.index.occ3 import SENTINEL, build_occ3, occ3_oracle
from mapcaller.index.packer import PackedReference
from mapcaller.ops.fm_device import DeviceFMIndex
from mapcaller.ops.fm3_device import (DeviceFM3, gather3, occ1_4,
                                          step1_update, step3_update)
from mapcaller.ops.fm_search import build_seed_kernel_packed
from mapcaller.pipeline.seeding import identify_simple_pairs


def _make_idx(seed, L):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    ref = PackedReference(["chr1"], [L], [0], codes, [])
    return build_index(None, packed=ref)


@pytest.fixture(scope="module")
def trio():
    idx = _make_idx(7, 2400)
    fm = DeviceFMIndex.from_host(idx)
    fm3 = DeviceFM3.from_host(idx, fm)
    return idx, fm, fm3


def test_occ3_counts_vs_bruteforce(trio):
    idx, _, _ = trio
    text = idx.ref.fwd_rc_codes()
    n = text.size
    tab = build_occ3(idx.sa_full, text)
    p = idx.sa_full.astype(np.int64)
    ps = np.where(p >= 3, p, 3)
    T = text.astype(np.int64)
    sym = np.where(p >= 3, T[ps - 3] * 16 + T[ps - 2] * 4 + T[ps - 1], SENTINEL)
    rng = np.random.default_rng(1)
    for _ in range(300):
        d = int(rng.integers(0, 64))
        i = int(rng.integers(0, n + 2))
        assert occ3_oracle(tab, d, i) == int((sym[:i] == d).sum())


def test_derived_occ1_matches_host_occ4(trio):
    idx, _, fm3 = trio
    rng = np.random.default_rng(2)
    ks = rng.integers(1, idx.seq_len + 1, size=128).astype(np.int32)

    @jax.jit
    def run(fm3, ks):
        cnt, syms, m = gather3(fm3, ks)
        return occ1_4(fm3, cnt, syms, m, ks)

    got = np.asarray(run(fm3, jnp.asarray(ks)))
    for i, k in enumerate(ks):
        want = idx.occ4(int(k) - 1)   # bwa occ4(k-1) counts rows < k
        assert np.array_equal(got[i], want), k


def _host_step(idx, x0, x1, x2, c):
    """bwa bwt_extend single step (the verified occ4 ladder)."""
    tk = idx.occ4(x1 - 1)
    tl = idx.occ4(x1 - 1 + x2)
    L2 = idx.L2
    ok_x1 = L2[:4] + 1 + tk
    ok_x2 = tl - tk
    adj = int((x1 <= idx.primary) and (x1 + x2 - 1 >= idx.primary))
    ok_x0 = np.zeros(4, np.int64)
    ok_x0[3] = x0 + adj
    ok_x0[2] = ok_x0[3] + ok_x2[3]
    ok_x0[1] = ok_x0[2] + ok_x2[2]
    ok_x0[0] = ok_x0[1] + ok_x2[1]
    ci = 3 - c
    return int(ok_x0[ci]), int(ok_x1[ci]), int(ok_x2[ci])


def _collect_cases(idx, patterns):
    """Walk patterns with the host oracle; return (state, bases, want1,
    want3) tuples covering both success and failure branches."""
    cases = []
    L2 = idx.L2
    for cs in patterns:
        c0 = int(cs[0])
        st = (int(L2[c0] + 1), int(L2[3 - c0] + 1), int(L2[c0 + 1] - L2[c0]))
        i = 1
        while i + 3 <= len(cs) and st[2] > 0:
            e = [int(cs[i]), int(cs[i + 1]), int(cs[i + 2])]
            w1 = _host_step(idx, *st, e[0])
            r3 = st
            for ee in e:
                if r3[2] > 0:
                    r3 = _host_step(idx, *r3, ee)
            cases.append((st, e, w1, r3))
            if r3[2] <= 0:
                break
            st = r3
            i += 3
    return cases


def test_step_updates_match_oracle(trio):
    idx, _, fm3 = trio
    rng = np.random.default_rng(3)
    text = idx.ref.fwd_rc_codes()
    pats = [rng.integers(0, 4, size=14) for _ in range(30)]
    # directed: patterns whose rc-interval passes through the correction
    # rows (suffixes at text positions 1 and 2): rc(P) occurring at
    # position 1 <=> P = rc(text[1:1+m])
    for m in (4, 7, 10, 13):
        pats.append((3 - text[1:1 + m])[::-1].astype(np.int64))
        pats.append((3 - text[2:2 + m])[::-1].astype(np.int64))
        pats.append((3 - text[0:m])[::-1].astype(np.int64))
    cases = _collect_cases(idx, pats)
    assert len(cases) > 60
    x0 = jnp.asarray([c[0][0] for c in cases], jnp.int32)
    x1 = jnp.asarray([c[0][1] for c in cases], jnp.int32)
    x2 = jnp.asarray([c[0][2] for c in cases], jnp.int32)
    e = [jnp.asarray([c[1][j] for c in cases], jnp.int32) for j in range(3)]

    @jax.jit
    def run(fm3, x0, x1, x2, e0, e1, e2):
        gk = gather3(fm3, x1)
        gl = gather3(fm3, x1 + x2)
        return (step1_update(fm3, x0, x1, x2, e0, gk, gl),
                step3_update(fm3, x0, x1, x2, e0, e1, e2, gk, gl))

    g1, g3 = jax.device_get(run(fm3, x0, x1, x2, *e))
    for ci, (st, ee, w1, w3) in enumerate(cases):
        got1 = tuple(int(v[ci]) for v in g1)
        if w1[2] > 0:
            assert got1 == w1, (ci, got1, w1)
        else:
            assert got1[2] == 0
        got3 = tuple(int(v[ci]) for v in g3)
        if w3[2] > 0:
            assert got3 == w3, (ci, got3, w3, st, ee)
        else:
            assert got3[2] == 0, (ci, got3, w3)


def test_occ3_seed_kernel_matches_oracle():
    """Full packed kernel on the 3-step table vs identify_simple_pairs,
    reads with mismatches/indels to exercise replay and tail modes."""
    idx = _make_idx(19, 5000)
    fm = DeviceFMIndex.from_host(idx)
    fm3 = DeviceFM3.from_host(idx, fm)
    rng = np.random.default_rng(4)
    text = idx.ref.fwd_rc_codes()
    B, W = 64, 128
    reads = []
    for i in range(B):
        ln = int(rng.integers(40, 121))
        pos = int(rng.integers(0, idx.genome_size - ln))
        r = text[pos:pos + ln].copy()
        nmut = int(rng.integers(0, 5))
        for _ in range(nmut):
            j = int(rng.integers(0, ln))
            r[j] = (r[j] + 1 + rng.integers(0, 3)) % 4
        reads.append(r)
    packed = np.zeros((B, W // 4), dtype=np.uint8)
    rlens = np.zeros(B, dtype=np.int32)
    for i, r in enumerate(reads):
        rlens[i] = len(r)
        for j, c in enumerate(r):
            packed[i, j >> 2] |= c << ((j & 3) * 2)

    kern = build_seed_kernel_packed(fm3, W, B, hits_per_read_x4=40)
    dev = kern(jnp.asarray(packed), jnp.asarray(rlens))
    counts, rpos, gpos, slen, overflow, buf_ovf = kern.collect(dev)
    assert not buf_ovf
    bounds = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(counts, out=bounds[1:])
    for i, r in enumerate(reads):
        want = identify_simple_pairs(idx, r)[:-1]   # drop sentinel
        want_set = sorted((p.rPos, p.gPos, p.rLen) for p in want)
        if overflow[i]:
            continue   # capacity overflow reads fall back on host
        s, t = bounds[i], bounds[i + 1]
        got = sorted(zip(rpos[s:t].tolist(), gpos[s:t].tolist(),
                         slen[s:t].tolist()))
        assert got == want_set, (i, got, want_set)


def test_occ3_seed_kernel_with_prefix_skip():
    """pfx_k > 0 must not change the seed set: the first-extension jump
    replaces the first K steps with one table gather."""
    idx = _make_idx(23, 4000)
    fm = DeviceFMIndex.from_host(idx)
    fm3 = DeviceFM3.from_host(idx, fm, pfx_k=8)
    rng = np.random.default_rng(6)
    text = idx.ref.fwd_rc_codes()
    B, W = 64, 128
    packed = np.zeros((B, W // 4), dtype=np.uint8)
    rlens = np.zeros(B, dtype=np.int32)
    reads = []
    for i in range(B):
        ln = int(rng.integers(30, 121))
        pos = int(rng.integers(0, idx.genome_size - 121))
        r = text[pos:pos + ln].copy()
        for _ in range(int(rng.integers(0, 4))):
            j = int(rng.integers(0, ln))
            r[j] = (r[j] + 1 + rng.integers(0, 3)) % 4
        reads.append(r)
        rlens[i] = ln
        for j, c in enumerate(r):
            packed[i, j >> 2] |= c << ((j & 3) * 2)
    kern = build_seed_kernel_packed(fm3, W, B, hits_per_read_x4=40)
    dev = kern(jnp.asarray(packed), jnp.asarray(rlens))
    counts, rpos, gpos, slen, overflow, buf_ovf = kern.collect(dev)
    assert not buf_ovf
    bounds = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(counts, out=bounds[1:])
    for i, r in enumerate(reads):
        if overflow[i]:
            continue
        want = sorted((p.rPos, p.gPos, p.rLen)
                      for p in identify_simple_pairs(idx, r)[:-1])
        s, t = bounds[i], bounds[i + 1]
        got = sorted(zip(rpos[s:t].tolist(), gpos[s:t].tolist(),
                         slen[s:t].tolist()))
        assert got == want, (i, got, want)
