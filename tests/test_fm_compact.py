"""Lane-compacted seed scan (_seed_scan3_compact) vs the lockstep scan:
per-read seed tables must be bit-identical for every compaction factor,
read-length mix, and queue-drain shape."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mapcaller.index.fmindex import build_index
from mapcaller.index.packer import PackedReference
from mapcaller.ops.fm3_device import DeviceFM3
from mapcaller.ops.fm_search import (MIN_SEED_LEN, _seed_scan3,
                                         _seed_scan3_compact)


def _mk(L=9000, seed=23):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    ref = PackedReference(["chr1"], [L], [0], codes, [])
    idx = build_index(None, packed=ref)
    return idx, DeviceFM3.from_host(idx), rng


def _reads(idx, rng, B, MAXLEN):
    text = idx.ref.fwd_rc_codes()
    mat = np.zeros((B, MAXLEN), dtype=np.uint8)
    rlens = np.zeros(B, dtype=np.int32)
    for b in range(B):
        ln = int(rng.integers(20, MAXLEN + 1)) if b % 4 else MAXLEN
        if b % 11 == 0:
            ln = int(rng.integers(4, MIN_SEED_LEN + 2))  # degenerate
        p = int(rng.integers(0, idx.genome_size - MAXLEN))
        r = text[p:p + ln].copy()
        for _ in range(int(rng.integers(0, 3))):
            j = int(rng.integers(0, ln))
            r[j] = (r[j] + 1 + rng.integers(0, 3)) % 4
        mat[b, :ln] = r
        rlens[b] = ln
    packed = np.zeros((B, MAXLEN // 4), dtype=np.uint8)
    for j in range(4):
        packed |= (mat[:, j::4] & 3) << (2 * j)
    return packed, rlens


def _words_le(packed, B):
    W4 = packed.shape[1]
    nwords = (W4 + 3) // 4
    pb = packed.astype(np.uint32).reshape(B, nwords, 4)
    sh = (np.arange(4, dtype=np.uint32) * 8)[None, None, :]
    return (pb << sh).sum(axis=2, dtype=np.uint32)


@pytest.mark.parametrize("factor", [1, 2, 4])
def test_compact_scan_matches_lockstep(factor):
    idx, fm3, rng = _mk()
    B, MAXLEN = 192, 64
    lanes = B // factor
    packed, rlens = _reads(idx, rng, B, MAXLEN)
    words = _words_le(packed, B)
    max_seeds = MAXLEN // (MIN_SEED_LEN + 1) + 2

    @jax.jit
    def lockstep(fm3, packed, rlens):
        W4 = packed.shape[1]
        nwords = (W4 + 3) // 4
        pb = packed.astype(jnp.uint32).reshape(B, nwords, 4)
        sh = (jnp.arange(4, dtype=jnp.uint32) * 8)[None, None, :]
        w = (pb << sh).sum(axis=2, dtype=jnp.uint32)
        widx = jnp.arange(nwords, dtype=jnp.int32)[None, :]

        def codes_fn(row, pos):
            wi = (pos >> 4)[:, None]
            ww = jnp.where(widx == wi, w, 0).sum(axis=1, dtype=jnp.uint32)
            return ((ww >> ((pos.astype(jnp.uint32) & 15) * 2)) & 3
                    ).astype(jnp.int32)

        return _seed_scan3(fm3, codes_fn, rlens, B, MAXLEN, max_seeds)

    @jax.jit
    def compact(fm3, words, rlens):
        return _seed_scan3_compact(fm3, words, rlens, B, lanes, MAXLEN,
                                   max_seeds)

    ref = [np.asarray(x) for x in lockstep(fm3, jnp.asarray(packed),
                                           jnp.asarray(rlens))]
    got = [np.asarray(x) for x in compact(fm3, jnp.asarray(words),
                                          jnp.asarray(rlens))]
    assert np.array_equal(got[0], ref[0]), "n_seeds"
    valid = np.arange(max_seeds)[None, :] < ref[0][:, None]
    names = ["rpos", "len", "x0", "freq"]
    for k in range(1, 5):
        assert np.array_equal(np.where(valid, got[k], 0),
                              np.where(valid, ref[k], 0)), names[k - 1]
    assert np.array_equal(got[5].astype(bool), ref[5].astype(bool)), "ovf"


@pytest.mark.parametrize("factor", [1, 2])
def test_fused_prefix_skip_matches_unfused(factor):
    """pfx_base > 0 (embedded prefix rows, fused skip at EVERY extension
    start — not just pos 0) must keep the seed set bit-identical, in
    both the lockstep and the lane-compacted scan."""
    idx, fm3_plain, rng = _mk(seed=71)
    fm3_fused = DeviceFM3.from_host(idx, fm3_plain.fm, pfx_k=7)
    assert fm3_fused.pfx_base > 0
    B, MAXLEN = 192, 64
    lanes = B // factor
    packed, rlens = _reads(idx, rng, B, MAXLEN)
    words = _words_le(packed, B)
    max_seeds = MAXLEN // (MIN_SEED_LEN + 1) + 2
    widx_n = (MAXLEN // 4 + 3) // 4

    def key_fn_for(fm3):
        def key_fn(row, pos):
            w = jnp.asarray(words)[row]
            wi = pos >> 4
            cols = jnp.arange(widx_n, dtype=jnp.int32)[None, :]
            w0 = jnp.where(cols == wi[:, None], w, 0).sum(
                axis=1, dtype=jnp.uint32)
            w1 = jnp.where(cols == (wi + 1)[:, None], w, 0).sum(
                axis=1, dtype=jnp.uint32)
            sh = ((pos & 15) * 2).astype(jnp.uint32)
            comb = (w0 >> sh) | jnp.where(
                sh > 0, w1 << (jnp.uint32(32) - sh), jnp.uint32(0))
            KK = fm3.pfx_k
            key = jnp.zeros_like(pos)
            for j in range(KK):
                key = key | (((comb >> jnp.uint32(2 * j)) & 3
                              ).astype(jnp.int32) << (2 * (KK - 1 - j)))
            return key
        return key_fn

    def codes_fn(row, pos):
        w = jnp.asarray(words)[row]
        wi = pos >> 4
        cols = jnp.arange(widx_n, dtype=jnp.int32)[None, :]
        ww = jnp.where(cols == wi[:, None], w, 0).sum(
            axis=1, dtype=jnp.uint32)
        return ((ww >> ((pos.astype(jnp.uint32) & 15) * 2)) & 3
                ).astype(jnp.int32)

    rl = jnp.asarray(rlens)
    ref = [np.asarray(x) for x in _seed_scan3(
        fm3_plain, codes_fn, rl, B, MAXLEN, max_seeds)]
    got_lock = [np.asarray(x) for x in _seed_scan3(
        fm3_fused, codes_fn, rl, B, MAXLEN, max_seeds,
        key_fn=key_fn_for(fm3_fused))]
    got_cmp = [np.asarray(x) for x in _seed_scan3_compact(
        fm3_fused, jnp.asarray(words), rl, B, lanes, MAXLEN, max_seeds)]
    valid = np.arange(max_seeds)[None, :] < ref[0][:, None]
    for got, tag in ((got_lock, "lockstep"), (got_cmp, "compact")):
        assert np.array_equal(got[0], ref[0]), f"n_seeds {tag}"
        for k in range(1, 5):
            assert np.array_equal(np.where(valid, got[k], 0),
                                  np.where(valid, ref[k], 0)), (tag, k)
        assert np.array_equal(got[5].astype(bool),
                              ref[5].astype(bool)), f"ovf {tag}"
