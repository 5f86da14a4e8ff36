"""x64 big-genome sharded index kernels (parallel/big_index.py):
shard-relative occ3 rows + int64 interval state + routed full-SA hits.

Bit-exactness is proven at toy scale against (a) the shard-relative
table reconstruction vs the absolute int32 table, and (b) the int32
replicated-index scan + host SA; the >2^31-row integration proof runs
in scripts/big_genome_proof.py (RAM-heavy, not a unit test)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from mapcaller.index.fmindex import build_index
from mapcaller.index.occ3 import build_occ3, build_occ3_64
from mapcaller.index.packer import PackedReference


def _toy_index(L=12000, seed=17):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    ref = PackedReference(["chr1"], [L], [0], codes, [])
    return build_index(None, packed=ref), rng


def test_occ3_64_shard_relative_reconstruction():
    idx, _ = _toy_index()
    text = idx.ref.fwd_rc_codes()
    sa64 = idx.sa_full.astype(np.int64)
    tab32 = build_occ3(idx.sa_full, text)
    nw3 = tab32.rows.shape[0]
    wps = -(-nw3 // 8)
    tab64 = build_occ3_64(sa64, text, words_per_shard=wps)
    assert tab64.rows.shape == tab32.rows.shape
    # absolute = base3[shard] + relative, for every word
    shard = np.arange(nw3) // wps
    abs_cnt = tab64.base3[shard] + tab64.rows[:, :64].astype(np.int64)
    assert np.array_equal(abs_cnt, tab32.rows[:, :64].astype(np.int64))
    # symbol words identical
    assert np.array_equal(tab64.rows[:, 64:68], tab32.rows[:, 64:68])
    assert np.array_equal(tab64.c3_first, tab32.c3_first.astype(np.int64))
    assert (tab64.row_p1, tab64.row_p2) == (tab32.row_p1, tab32.row_p2)
    assert (tab64.t0, tab64.t1, tab64.tail1, tab64.tail2a, tab64.tail2b) == \
        (tab32.t0, tab32.t1, tab32.tail1, tab32.tail2a, tab32.tail2b)


def test_big_kernel_matches_int32_scan_and_host_sa():
    """The x64 sharded kernel's seed tables must equal the replicated
    int32 scan's, and its routed full-SA hit locations must equal the
    host suffix array's."""
    from mapcaller.ops.fm3_device import DeviceFM3
    from mapcaller.ops.fm_search import MIN_SEED_LEN, _seed_scan3
    from mapcaller.parallel.big_index import (
        build_big_seed_hits_kernel, shard_rows)
    from mapcaller.parallel.mesh import make_mesh

    idx, rng = _toy_index()
    fm3 = DeviceFM3.from_host(idx)
    n_dev = 8
    mesh = make_mesh(n_dev)
    B, MAXLEN = 16, 64
    BG = B * n_dev
    text = idx.ref.fwd_rc_codes()
    mat = np.zeros((BG, MAXLEN), dtype=np.uint8)
    rlens = np.full(BG, 60, dtype=np.int32)
    for b in range(BG):
        p = int(rng.integers(0, idx.genome_size - 60))
        r = text[p:p + 60].copy()
        if b % 3 == 0:
            j = int(rng.integers(0, 60))
            r[j] = (r[j] + 1 + rng.integers(0, 3)) % 4
        mat[b, :60] = r
    packed = np.zeros((BG, MAXLEN // 4), dtype=np.uint8)
    for j in range(4):
        packed |= (mat[:, j::4] & 3) << (2 * j)

    sa64 = idx.sa_full.astype(np.int64)
    nw3 = np.asarray(fm3.occ3_rows).shape[0]
    wps = -(-nw3 // n_dev)
    tab64 = build_occ3_64(sa64, text, words_per_shard=wps)
    occ_slices, rps = shard_rows(tab64.rows, n_dev)
    assert rps == wps
    base3 = np.zeros((n_dev, 64), dtype=np.int64)
    base3[:tab64.base3.shape[0]] = tab64.base3
    sa_slices, _ = shard_rows(sa64, n_dev)
    statics = dict(primary=int(idx.primary), row_p1=tab64.row_p1,
                   row_p2=tab64.row_p2, t0=tab64.t0, t1=tab64.t1,
                   tail1=tab64.tail1, tail2a=tab64.tail2a,
                   tail2b=tab64.tail2b)

    with jax.enable_x64(True):
        fn = build_big_seed_hits_kernel(mesh, n_dev, MAXLEN, B, statics)
        occ_s = jax.device_put(jnp.asarray(occ_slices),
                               NamedSharding(mesh, P("dp", None, None)))
        b3 = jax.device_put(jnp.asarray(base3), NamedSharding(mesh, P(None, None)))
        c3f = jax.device_put(jnp.asarray(tab64.c3_first),
                             NamedSharding(mesh, P(None)))
        L2 = jax.device_put(jnp.asarray(np.asarray(idx.L2, dtype=np.int64)),
                            NamedSharding(mesh, P(None)))
        sa_s = jax.device_put(jnp.asarray(sa_slices),
                              NamedSharding(mesh, P("dp", None)))
        pk = jax.device_put(jnp.asarray(packed),
                            NamedSharding(mesh, P("dp", None)))
        rl = jax.device_put(jnp.asarray(rlens), NamedSharding(mesh, P("dp")))
        got = [np.asarray(x) for x in
               jax.device_get(fn(occ_s, b3, c3f, L2, sa_s, pk, rl))]
    (n_seeds, s_rpos, s_len, s_x0, s_freq, overflow,
     hit_read, hit_rpos, hit_len, hit_loc, hit_valid, buf_ovf) = got
    assert s_x0.dtype == np.int64 and hit_loc.dtype == np.int64

    # (a) seed tables == replicated int32 scan
    max_seeds = MAXLEN // (MIN_SEED_LEN + 1) + 2

    @jax.jit
    def ref_scan(fm3, packed, rlens):
        W4 = packed.shape[1]
        nwords = (W4 + 3) // 4
        pb = packed.astype(jnp.uint32).reshape(BG, nwords, 4)
        sh = (jnp.arange(4, dtype=jnp.uint32) * 8)[None, None, :]
        words = (pb << sh).sum(axis=2, dtype=jnp.uint32)
        widx = jnp.arange(nwords, dtype=jnp.int32)[None, :]

        def codes_fn(row, pos):
            wi = (pos >> 4)[:, None]
            w = jnp.where(widx == wi, words, 0).sum(axis=1,
                                                    dtype=jnp.uint32)
            return ((w >> ((pos.astype(jnp.uint32) & 15) * 2)) & 3
                    ).astype(jnp.int32)

        return _seed_scan3(fm3, codes_fn, rlens, BG, MAXLEN, max_seeds)

    ref = [np.asarray(x) for x in jax.device_get(
        ref_scan(fm3, jnp.asarray(packed), jnp.asarray(rlens)))]
    assert np.array_equal(n_seeds, ref[0])
    valid = np.arange(max_seeds)[None, :] < ref[0][:, None]
    for gi, ri in ((s_rpos, ref[1]), (s_len, ref[2]), (s_x0, ref[3]),
                   (s_freq, ref[4])):
        assert np.array_equal(np.where(valid, gi, 0),
                              np.where(valid, ri, 0))
    assert np.array_equal(overflow.astype(bool), ref[5].astype(bool))

    # (b) hit locations == host suffix array at the same rows
    sa_host = sa64
    n_checked = 0
    Hd = hit_loc.shape[0] // n_dev
    for d in range(n_dev):
        for h in range(Hd):
            i = d * Hd + h
            if not hit_valid[i]:
                continue
            r = int(hit_read[i])
            # reconstruct the row from the seed tables: find the seed
            # this hit belongs to via (rpos, len) then row = x0 + offset
            # simpler: verify loc is one of the sa values of its seed
            srow = None
            for s in range(int(n_seeds[r])):
                if (s_rpos[r, s] == hit_rpos[i]
                        and s_len[r, s] == hit_len[i]):
                    srow = s
                    break
            assert srow is not None
            x0 = int(s_x0[r, srow])
            fr = int(s_freq[r, srow])
            locs = {int(sa_host[x0 + k]) for k in range(fr)}
            assert int(hit_loc[i]) in locs
            n_checked += 1
    assert n_checked > 50
