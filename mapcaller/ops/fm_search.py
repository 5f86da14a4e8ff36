"""Batched greedy MEM seeding on device (JAX).

Device equivalent of BWT_Search + IdentifySimplePairs
(ref: src/bwt_search.cpp:121-164, src/ReadMapping.cpp:125-158): every
read in the batch advances one state-machine step per iteration of a
single while_loop — either consuming one base of the current
bidirectional-interval extension (two batched occ4 lookups) or
finalizing a seed and skipping ahead. Total iterations are bounded by
max_len + 2 * max_seeds, so a whole batch seeds in O(read_len) fused
device steps regardless of batch size.

Suffix-array resolution then compacts all (seed, hit) pairs into a flat
hit buffer with `jnp.repeat(..., total_repeat_length)` and walks
inverse-Psi in lockstep (<= 31 masked steps, ref: bwt_search.cpp:109-119).
"""
from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from .fm_device import DeviceFMIndex, occ4, sa_resolve

OCC_THR = 50

def _pfx_entry(cnt64, key):
    """Extract the packed prefix entry (x0, x1, x2) for prefix key
    `key` from a gathered 72-int32 row whose 64 count slots hold 16
    packed 4-int32 entries (ops/fm3_device._embed_pfx): entry index =
    key & 15, component j at slot (key & 15) * 4 + j."""
    import numpy as _np
    d64 = jnp.asarray(_np.arange(64, dtype=_np.int32))[None, :]
    base = ((key & 15) << 2)[:, None]
    x0 = jnp.where(d64 == base, cnt64, 0).sum(axis=-1)
    x1 = jnp.where(d64 == base + 1, cnt64, 0).sum(axis=-1)
    x2 = jnp.where(d64 == base + 2, cnt64, 0).sum(axis=-1)
    return x0, x1, x2

MIN_SEED_LEN = 16


def crumb_lookup(packed: jnp.ndarray, row: jnp.ndarray,
                 pos: jnp.ndarray) -> jnp.ndarray:
    """2-bit code fetch from packed uint8[B, ceil(W/4)] read matrix.
    Reads containing N never reach the device (host-oracle fallback),
    so 2 bits/base is lossless here. pos is clamped by the caller's
    masks; out-of-range crumbs are garbage but never used."""
    W4 = packed.shape[1]
    byte = packed[row, jnp.clip(pos >> 2, 0, W4 - 1)].astype(jnp.int32)
    return (byte >> ((pos & 3) * 2)) & 3


def _seed_scan3(fm3, codes_fn, rlens, B, max_len, max_seeds, key_fn=None,
                gather_fn=None, sync_axis=None, idx_dtype=None,
                with_iters=False):
    """Greedy-MEM state machine on the 3-step occ table (ops/fm3_device):
    extensions advance 3 bases per iteration (2 gathers) while >=3 bases
    remain; on a 3-step failure the lane replays from the saved state
    with derived 1-steps to find the exact MEM end (<=3 iterations, no
    extra table); tail bases (<3 left) use derived 1-steps too. Seed set
    is bit-identical to _seed_scan / BWT_Search (ref: bwt_search.cpp:
    121-164).

    idx_dtype: dtype of the interval state (x0/x1/x2) and the per-seed
    x0/freq tables. int32 by default; the big-genome path (>2^31-row
    texts, ref index types are uint64 — src/BWT_Index/bwt.h:44) passes
    int64 under jax x64 and a gather_fn that recombines shard-relative
    rows to absolute int64 counts.

    With fm3.pfx_base > 0 and a key_fn, every extension START jumps
    pfx_k bases in its single iteration: the start lane's (otherwise
    dummy) first occ3 gather fetches the embedded prefix row instead —
    ZERO extra gathers. Empty entries (MEM ends inside the first K <
    MinSeedLength bases) fall back to the 1-base init; the replay walk
    then finds the exact end, so the seed set stays bit-identical
    (ref: src/bwt_search.cpp:121-164)."""
    from .fm3_device import gather3, step1_update, step3_update
    if gather_fn is None:
        gather_fn = gather3
    if idx_dtype is None:
        idx_dtype = jnp.int32
    L2 = fm3.L2
    primary = fm3.primary
    FUSE = bool(getattr(fm3, "pfx_base", 0)) and key_fn is not None
    K = fm3.pfx_k if FUSE else 0
    PFXI = (int(fm3.pfx_base) << 4) if FUSE else 0

    def step(state):
        (pos, in_ext, replay, start, ext_pos, x0, x1, x2,
         n_seeds, s_rpos, s_len, s_x0, s_freq, overflow, iters) = state
        bidx = jnp.arange(B, dtype=jnp.int32)
        stop_pos = rlens - MIN_SEED_LEN
        done = (~in_ext) & (pos >= stop_pos)
        active = ~done
        iters = iters + active.astype(jnp.int32)   # per-lane trajectory len

        cpos = codes_fn(bidx, jnp.minimum(pos, max_len - 1))
        start_new = active & (~in_ext)
        x0_init = L2[cpos & 3] + 1
        x1_init = L2[(3 - cpos) & 3] + 1
        x2_init = L2[(cpos & 3) + 1] - L2[cpos & 3]
        ext_init = pos + 1
        replay_init = jnp.zeros(B, bool)

        ext_active = active & in_ext
        at_end = ext_active & (ext_pos >= rlens)
        extending = ext_active & ~at_end
        use3 = extending & (~replay) & (ext_pos + 3 <= rlens)
        use1 = extending & ~use3

        e0 = codes_fn(bidx, jnp.minimum(ext_pos, max_len - 1))
        e1 = codes_fn(bidx, jnp.minimum(ext_pos + 1, max_len - 1))
        e2 = codes_fn(bidx, jnp.minimum(ext_pos + 2, max_len - 1))

        k = jnp.where(extending, x1, 0)
        l = jnp.where(extending, x1 + x2, 0)
        if FUSE:
            # start lanes hijack their dummy gather: fetch the embedded
            # prefix row for the K-mer at pos (see module docstring)
            key = key_fn(bidx, jnp.minimum(pos, max_len - 1))
            # packed rows: key >> 4 selects the row, key & 15 the entry
            k = jnp.where(start_new, PFXI + key, k)
        gk = gather_fn(fm3, k)
        gl = gather_fn(fm3, l)
        if FUSE:
            p_x0, p_x1, p_x2 = _pfx_entry(gk[0], key)
            jump = start_new & (p_x2 > 0)
            x0_init = jnp.where(jump, p_x0, x0_init)
            x1_init = jnp.where(jump, p_x1, x1_init)
            x2_init = jnp.where(jump, p_x2, x2_init)
            ext_init = jnp.where(jump, pos + K, ext_init)
        n3_x0, n3_x1, n3_x2 = step3_update(fm3, x0, k, x2, e0, e1, e2, gk, gl)
        n1_x0, n1_x1, n1_x2 = step1_update(fm3, x0, k, x2, e0, gk, gl)

        fail3 = use3 & (n3_x2 <= 0)     # exact end within these 3 bases
        ok3 = use3 & ~fail3
        fail1 = use1 & (n1_x2 <= 0)
        ok1 = use1 & ~fail1

        finalize = at_end | fail1
        slen = ext_pos - start
        good = finalize & (slen >= MIN_SEED_LEN) & (x2 <= OCC_THR)
        slot = jnp.minimum(n_seeds, max_seeds - 1)
        overflow = overflow | (finalize & good & (n_seeds >= max_seeds))

        onehot = (jnp.arange(max_seeds, dtype=jnp.int32)[None, :] == slot[:, None]
                  ) & good[:, None]

        def put(arr, val):
            return jnp.where(onehot, val[:, None], arr)

        s_rpos = put(s_rpos, start)
        s_len = put(s_len, slen)
        s_x0 = put(s_x0, x0)
        s_freq = put(s_freq, x2)
        n_seeds = jnp.where(good, jnp.minimum(n_seeds + 1, max_seeds), n_seeds)

        pos = jnp.where(finalize, start + slen + 1, pos)
        x0 = jnp.where(start_new, x0_init,
             jnp.where(ok3, n3_x0, jnp.where(ok1, n1_x0, x0)))
        x1 = jnp.where(start_new, x1_init,
             jnp.where(ok3, n3_x1, jnp.where(ok1, n1_x1, x1)))
        x2 = jnp.where(start_new, x2_init,
             jnp.where(ok3, n3_x2, jnp.where(ok1, n1_x2, x2)))
        start = jnp.where(start_new, pos, start)
        ext_pos = jnp.where(start_new, ext_init,
                  jnp.where(ok3, ext_pos + 3,
                  jnp.where(ok1, ext_pos + 1, ext_pos)))
        in_ext = jnp.where(start_new, True, jnp.where(finalize, False, in_ext))
        replay = jnp.where(finalize, False,
                 jnp.where(start_new, replay_init, replay | fail3))

        return (pos, in_ext, replay, start, ext_pos, x0, x1, x2,
                n_seeds, s_rpos, s_len, s_x0, s_freq, overflow, iters)

    z = rlens * 0
    zb = z != 0
    zi = z.astype(idx_dtype)       # keeps the carry varying over the mesh
    zs = jnp.zeros((B, max_seeds), dtype=jnp.int32) + z[:, None]
    zsi = jnp.zeros((B, max_seeds), dtype=idx_dtype) + zi[:, None]
    state = (z, zb, zb, z, z, zi, zi, zi, z, zs, zs, zsi, zsi, zb, z)
    # worst case ~1.5 iterations/base (len-1 MEMs: init + 3-fail +
    # 1-replay-fail per 2-base advance) + 2/seed finalize
    n_iters = (3 * max_len) // 2 + 2 * max_seeds + 8
    UNROLL = 8
    n_blocks = (n_iters + UNROLL - 1) // UNROLL

    def block_cond(carry):
        i, s = carry
        pos, in_ext = s[0], s[1]
        active = jnp.any(in_ext | (pos < rlens - MIN_SEED_LEN))
        if sync_axis is not None:
            # collectives inside the body (sharded-index routing) need
            # every device to run the same trip count
            active = jax.lax.psum(active.astype(jnp.int32), sync_axis) > 0
        return (i < n_blocks) & active

    def block_body(carry):
        i, s = carry
        for _ in range(UNROLL):
            s = step(s)
        return i + 1, s

    _, state = jax.lax.while_loop(block_cond, block_body, (jnp.int32(0), state))
    (_, _, _, _, _, _, _, _, n_seeds, s_rpos, s_len, s_x0, s_freq,
     overflow, iters) = state
    if with_iters:
        return n_seeds, s_rpos, s_len, s_x0, s_freq, overflow, iters
    return n_seeds, s_rpos, s_len, s_x0, s_freq, overflow


def _seed_scan3_compact(fm3, words_all, rlens_all, B_total, lanes, max_len,
                        max_seeds, gather_fn=None, sync_axis=None,
                        idx_dtype=None):
    """Lane-compacted greedy-MEM scan: `lanes` hardware lanes stream
    through B_total reads, so the lockstep batch costs ~the MEAN lane
    trajectory instead of the MAX (measured 37 vs 56 iterations on the
    headline workload, scripts/measure_lane_traj.py). Ref hot loop
    being matched: src/bwt_search.cpp:121-164.

    Design: the inner 16-step blocks are IDENTICAL in cost to the
    lockstep scan — per-lane read words live in lane state (no indirect
    codes fetch) and seeds emit into per-LANE tables with the same cheap
    onehot writes. The expensive machinery (flush finished lanes' seed
    rows to the per-READ output tables, refill from the queue, gather
    the new reads' words) runs once per block, so its scatters amortize
    16x. A first cut that retired lanes every iteration spent more on
    scatter/indirection per step than the compaction saved and lost to
    lockstep — do not resurrect it.

    Per-read outputs are bit-identical to _seed_scan3, so downstream
    SA-resolve / chain / classify stages are unchanged.

    words_all: uint32[B_total, nwords] packed read words (LE crumb
    order, word w covers read positions [16w, 16w+16)).
    rlens_all: int32[B_total]."""
    from .fm3_device import gather3, step1_update, step3_update
    if gather_fn is None:
        gather_fn = gather3
    if idx_dtype is None:
        idx_dtype = jnp.int32
    L2 = fm3.L2
    primary = fm3.primary
    FUSE = bool(getattr(fm3, "pfx_base", 0))
    K = fm3.pfx_k if FUSE else 0
    PFXI = (int(fm3.pfx_base) << 4) if FUSE else 0
    S = max_seeds
    nwords = words_all.shape[1]
    # dump row B_total: rlen 0 -> instantly done, never emits
    words_pad = jnp.concatenate(
        [words_all, jnp.zeros((1, nwords), words_all.dtype)], axis=0)
    rlens_pad = jnp.concatenate(
        [rlens_all, jnp.zeros(1, rlens_all.dtype)])
    DROP = B_total + 1          # out-of-range scatter index == no write
    widx = jnp.arange(nwords, dtype=jnp.int32)[None, :]

    def step(state):
        (qhead, rd, rlen_l, words_l, pos, in_ext, replay, start, ext_pos,
         x0, x1, x2, ns_l, ovf_l, lrpos, llen, lx0, lfreq,
         n_seeds, s_rpos, s_len, s_x0, s_freq, overflow) = state
        done = (~in_ext) & (pos >= rlen_l - MIN_SEED_LEN)
        active = ~done

        def codes_l(p):
            p = jnp.minimum(p, max_len - 1)
            wi = (p >> 4)[:, None]
            w = jnp.where(widx == wi, words_l, 0).sum(axis=1,
                                                      dtype=jnp.uint32)
            return ((w >> ((p.astype(jnp.uint32) & 15) * 2)) & 3
                    ).astype(jnp.int32)

        cpos = codes_l(pos)
        start_new = active & (~in_ext)
        x0_init = L2[cpos & 3] + 1
        x1_init = L2[(3 - cpos) & 3] + 1
        x2_init = L2[(cpos & 3) + 1] - L2[cpos & 3]
        ext_init = pos + 1

        ext_active = active & in_ext
        at_end = ext_active & (ext_pos >= rlen_l)
        extending = ext_active & ~at_end
        use3 = extending & (~replay) & (ext_pos + 3 <= rlen_l)
        use1 = extending & ~use3

        e0 = codes_l(ext_pos)
        e1 = codes_l(ext_pos + 1)
        e2 = codes_l(ext_pos + 2)

        k = jnp.where(extending, x1, 0)
        l = jnp.where(extending, x1 + x2, 0)
        if FUSE:
            # fused prefix-skip (see _seed_scan3): start lanes' dummy
            # gather fetches the embedded prefix row for the K-mer at pos
            p = jnp.minimum(pos, max_len - 1)
            wi = p >> 4
            w0 = jnp.where(widx == wi[:, None], words_l, 0).sum(
                axis=1, dtype=jnp.uint32)
            w1 = jnp.where(widx == (wi + 1)[:, None], words_l, 0).sum(
                axis=1, dtype=jnp.uint32)
            sh = ((p & 15) * 2).astype(jnp.uint32)
            comb = (w0 >> sh) | jnp.where(sh > 0,
                                          w1 << (jnp.uint32(32) - sh),
                                          jnp.uint32(0))
            key = jnp.zeros_like(p)
            for j in range(K):
                key = key | (((comb >> jnp.uint32(2 * j)) & 3
                              ).astype(jnp.int32) << (2 * (K - 1 - j)))
            # packed rows: key >> 4 selects the row, key & 15 the entry
            k = jnp.where(start_new, PFXI + key, k)
        gk = gather_fn(fm3, k)
        gl = gather_fn(fm3, l)
        if FUSE:
            p_x0, p_x1, p_x2 = _pfx_entry(gk[0], key)
            jump = start_new & (p_x2 > 0)
            x0_init = jnp.where(jump, p_x0, x0_init)
            x1_init = jnp.where(jump, p_x1, x1_init)
            x2_init = jnp.where(jump, p_x2, x2_init)
            ext_init = jnp.where(jump, pos + K, ext_init)
        n3_x0, n3_x1, n3_x2 = step3_update(fm3, x0, k, x2, e0, e1, e2,
                                           gk, gl)
        n1_x0, n1_x1, n1_x2 = step1_update(fm3, x0, k, x2, e0, gk, gl)

        fail3 = use3 & (n3_x2 <= 0)
        ok3 = use3 & ~fail3
        fail1 = use1 & (n1_x2 <= 0)
        ok1 = use1 & ~fail1

        finalize = at_end | fail1
        slen = ext_pos - start
        good = finalize & (slen >= MIN_SEED_LEN) & (x2 <= OCC_THR)
        slot = jnp.minimum(ns_l, S - 1)
        ovf_l = ovf_l | (finalize & good & (ns_l >= S))

        onehot = (jnp.arange(S, dtype=jnp.int32)[None, :] == slot[:, None]
                  ) & good[:, None]

        def put(arr, val):
            return jnp.where(onehot, val[:, None], arr)

        lrpos = put(lrpos, start)
        llen = put(llen, slen)
        lx0 = put(lx0, x0)
        lfreq = put(lfreq, x2)
        ns_l = jnp.where(good, jnp.minimum(ns_l + 1, S), ns_l)

        pos = jnp.where(finalize, start + slen + 1, pos)
        x0 = jnp.where(start_new, x0_init,
             jnp.where(ok3, n3_x0, jnp.where(ok1, n1_x0, x0)))
        x1 = jnp.where(start_new, x1_init,
             jnp.where(ok3, n3_x1, jnp.where(ok1, n1_x1, x1)))
        x2 = jnp.where(start_new, x2_init,
             jnp.where(ok3, n3_x2, jnp.where(ok1, n1_x2, x2)))
        start = jnp.where(start_new, pos, start)
        ext_pos = jnp.where(start_new, ext_init,
                  jnp.where(ok3, ext_pos + 3,
                  jnp.where(ok1, ext_pos + 1, ext_pos)))
        in_ext = jnp.where(start_new, True,
                           jnp.where(finalize, False, in_ext))
        replay = jnp.where(finalize, False,
                 jnp.where(start_new, False, replay | fail3))

        return (qhead, rd, rlen_l, words_l, pos, in_ext, replay, start,
                ext_pos, x0, x1, x2, ns_l, ovf_l, lrpos, llen, lx0, lfreq,
                n_seeds, s_rpos, s_len, s_x0, s_freq, overflow)

    def compact(state):
        """Flush finished lanes' per-lane seed rows into the per-read
        tables, then refill from the queue (runs once per block)."""
        (qhead, rd, rlen_l, words_l, pos, in_ext, replay, start, ext_pos,
         x0, x1, x2, ns_l, ovf_l, lrpos, llen, lx0, lfreq,
         n_seeds, s_rpos, s_len, s_x0, s_freq, overflow) = state
        done = (~in_ext) & (pos >= rlen_l - MIN_SEED_LEN)
        valid = rd < B_total
        flush = done & valid
        wb = jnp.where(flush, rd, DROP)
        n_seeds = n_seeds.at[wb].set(ns_l, mode="drop")
        overflow = overflow.at[wb].set(ovf_l, mode="drop")
        s_rpos = s_rpos.at[wb].set(lrpos, mode="drop")
        s_len = s_len.at[wb].set(llen, mode="drop")
        s_x0 = s_x0.at[wb].set(lx0, mode="drop")
        s_freq = s_freq.at[wb].set(lfreq, mode="drop")

        rank = jnp.cumsum(flush.astype(jnp.int32)) - 1
        newrd = qhead + rank
        take = flush & (newrd < B_total)
        qhead = qhead + take.sum()
        nr = jnp.clip(newrd, 0, B_total)
        rd = jnp.where(take, newrd, jnp.where(flush, B_total, rd))
        rlen_l = jnp.where(take, rlens_pad[nr], jnp.where(flush, 0, rlen_l))
        words_l = jnp.where(take[:, None], words_pad[nr], words_l)
        pos = jnp.where(take, 0, pos)
        in_ext = in_ext & ~take
        replay = replay & ~take
        ns_l = jnp.where(take, 0, ns_l)
        ovf_l = ovf_l & ~take
        tk = take[:, None]
        lrpos = jnp.where(tk, 0, lrpos)
        llen = jnp.where(tk, 0, llen)
        lx0 = jnp.where(tk, 0, lx0)
        lfreq = jnp.where(tk, 0, lfreq)
        return (qhead, rd, rlen_l, words_l, pos, in_ext, replay, start,
                ext_pos, x0, x1, x2, ns_l, ovf_l, lrpos, llen, lx0, lfreq,
                n_seeds, s_rpos, s_len, s_x0, s_freq, overflow)

    lane0 = jnp.arange(lanes, dtype=jnp.int32)
    rd0 = jnp.where(lane0 < B_total, lane0, B_total)
    z = jnp.zeros(lanes, dtype=jnp.int32) + rlens_pad[rd0] * 0
    zb = z != 0
    zi = z.astype(idx_dtype)
    qhead0 = jnp.minimum(jnp.int32(lanes), jnp.int32(B_total))
    zvar = rlens_all[0] * 0
    n_seeds0 = jnp.zeros(B_total + 1, jnp.int32) + zvar
    g32 = jnp.zeros((B_total + 1, S), jnp.int32) + n_seeds0[:, None]
    gi = jnp.zeros((B_total + 1, S), idx_dtype) + n_seeds0[:, None
                                                           ].astype(idx_dtype)
    ovf0 = n_seeds0 != 0
    l32 = jnp.zeros((lanes, S), jnp.int32) + z[:, None]
    li = jnp.zeros((lanes, S), idx_dtype) + zi[:, None]
    state = (qhead0, rd0, rlens_pad[rd0], words_pad[rd0], z, zb, zb, z, z,
             zi, zi, zi, z, zb, l32, l32, li, li,
             n_seeds0, g32, g32, gi, gi, ovf0)

    base = (3 * max_len) // 2 + 2 * max_seeds + 8
    n_iters = base * (-(-B_total // lanes)) + base
    import os as _os
    UNROLL = int(_os.environ.get("MC_COMPACT_UNROLL", "16"))
    n_blocks = (n_iters + UNROLL - 1) // UNROLL

    def block_cond(carry):
        i, s = carry
        qhead, rd, rlen_l, _w, pos, in_ext = s[0], s[1], s[2], s[3], s[4], s[5]
        busy = jnp.any(in_ext | (pos < rlen_l - MIN_SEED_LEN))
        act = busy | (qhead < B_total)
        if sync_axis is not None:
            act = jax.lax.psum(act.astype(jnp.int32), sync_axis) > 0
        return (i < n_blocks) & act

    def block_body(carry):
        i, s = carry
        for _ in range(UNROLL):
            s = step(s)
        s = compact(s)
        return i + 1, s

    _, state = jax.lax.while_loop(block_cond, block_body,
                                  (jnp.int32(0), state))
    state = compact(state)      # flush lanes that finished in the last block
    (_, _, _, _, _, _, _, _, _, _, _, _, _, _, _, _, _, _,
     n_seeds, s_rpos, s_len, s_x0, s_freq, overflow) = state
    return (n_seeds[:B_total], s_rpos[:B_total], s_len[:B_total],
            s_x0[:B_total], s_freq[:B_total], overflow[:B_total])


def build_seed_kernel_packed(fm_template, max_len: int,
                             batch: int, hits_per_read_x4: int = 9,
                             compact_lanes: int = 0):
    """Transfer-optimized batched seeding (every transfer pays a fixed
    latency plus bytes over the host link):

      input:  packed 2-bit codes uint8[B, W/4]  (8x smaller than bytes),
              rlens int32[B]
      output: ONE int32 vector =
              [hit_w[H]   : rpos<<9 | len  (0 => empty slot),
               hit_loc[H] : text position of the hit,
               counts2[B/2]: per-read kept-hit counts, 2 x int16 per word,
               ovfbits[B/32], total_kept, buffer_overflow]

    Hits are filtered on device (PosDiff > 0, exactly the host filter)
    and compacted grouped-by-read, so the host hands them straight to
    the native chainer. H = B * hits_per_read_x4 / 4 pooled across the
    batch (measured ~1.5 kept hits/read; overflow reruns via a larger
    kernel tier)."""
    assert batch % 32 == 0 and max_len <= 511
    max_seeds = max_len // (MIN_SEED_LEN + 1) + 2
    H = batch * hits_per_read_x4 // 4
    from .fm3_device import DeviceFM3
    use_occ3 = isinstance(fm_template, DeviceFM3)

    def kernel(fm, packed: jnp.ndarray, rlens: jnp.ndarray):
        B = batch
        # pre-assemble the whole read as uint32 words (16 crumbs each):
        # code lookups then become an 8/16-way one-hot select over the
        # word columns — pure VPU ops instead of per-lane gathers, which
        # are the kernel's scarce resource.
        W4 = packed.shape[1]
        nwords = (W4 + 3) // 4
        pb = packed.astype(jnp.uint32).reshape(B, nwords, 4)
        sh = (jnp.arange(4, dtype=jnp.uint32) * 8)[None, None, :]
        words = (pb << sh).sum(axis=2, dtype=jnp.uint32)     # [B, nwords]
        widx = jnp.arange(nwords, dtype=jnp.int32)[None, :]

        def codes_fn(row, pos):
            wi = (pos >> 4)[:, None]
            w = jnp.where(widx == wi, words, 0).sum(axis=1, dtype=jnp.uint32)
            return ((w >> ((pos.astype(jnp.uint32) & 15) * 2)) & 3
                    ).astype(jnp.int32)


        def key_fn(row, pos):
            wi = pos >> 4
            w0 = jnp.where(widx == wi[:, None], words, 0).sum(
                axis=1, dtype=jnp.uint32)
            w1 = jnp.where(widx == (wi + 1)[:, None], words, 0).sum(
                axis=1, dtype=jnp.uint32)
            sh = ((pos & 15) * 2).astype(jnp.uint32)
            lo = w0 >> sh
            hi = jnp.where(sh > 0, w1 << (jnp.uint32(32) - sh),
                           jnp.uint32(0))
            comb = lo | hi
            KK = fm_template.pfx_k
            key = jnp.zeros_like(pos)
            for j in range(KK):
                key = key | (((comb >> jnp.uint32(2 * j)) & 3
                              ).astype(jnp.int32) << (2 * (KK - 1 - j)))
            return key

        kf = key_fn if (use_occ3 and getattr(fm_template, "pfx_k", 0)) else None

        if use_occ3 and compact_lanes and compact_lanes < B:
            # lane-compacted scan (cost ~ mean trajectory, not max);
            # the fused prefix-skip engages automatically (fm.pfx_base)
            (n_seeds, s_rpos, s_len, s_x0, s_freq, overflow) = \
                _seed_scan3_compact(fm, words, rlens, B, compact_lanes,
                                    max_len, max_seeds)
        elif use_occ3:
            (n_seeds, s_rpos, s_len, s_x0, s_freq, overflow) = _seed_scan3(
                fm, codes_fn, rlens, B, max_len, max_seeds, key_fn=kf)
        else:
            (n_seeds, s_rpos, s_len, s_x0, s_freq, overflow) = _seed_scan(
                fm, codes_fn, rlens, B, max_len, max_seeds, has_n=False)

        sidx = jnp.arange(max_seeds, dtype=jnp.int32)[None, :]
        seed_valid = sidx < n_seeds[:, None]
        freqs = jnp.where(seed_valid, s_freq, 0).reshape(-1)
        x0s = s_x0.reshape(-1)
        rposs = s_rpos.reshape(-1)
        lens = s_len.reshape(-1)
        readix = jnp.repeat(jnp.arange(B, dtype=jnp.int32), max_seeds)

        total_raw = freqs.sum()
        csum = jnp.cumsum(freqs) - freqs
        hpos = jnp.arange(H, dtype=jnp.int32)
        seg_start = jnp.repeat(csum, freqs, total_repeat_length=H)
        within = hpos - seg_start
        hit_row = jnp.repeat(x0s, freqs, total_repeat_length=H) + within
        hit_rpos = jnp.repeat(rposs, freqs, total_repeat_length=H)
        hit_len = jnp.repeat(lens, freqs, total_repeat_length=H)
        hit_read = jnp.repeat(readix, freqs, total_repeat_length=H)
        hit_valid = hpos < jnp.minimum(total_raw, H)
        buffer_overflow = total_raw > H

        fm1 = fm.fm if use_occ3 else fm
        hit_loc, resolved = sa_resolve(fm1, jnp.where(hit_valid, hit_row, 32),
                                       hit_valid)
        unresolved_read = jnp.zeros(B, dtype=jnp.int32).at[hit_read].max(
            (hit_valid & ~resolved).astype(jnp.int32))
        overflow = overflow | (unresolved_read > 0)

        # device-side PosDiff > 0 filter (ReadMapping.cpp:136 keeps only
        # hits right of the read origin) + stable compaction by hit order
        keep = hit_valid & ((hit_loc - hit_rpos) > 0)
        dest = jnp.cumsum(keep.astype(jnp.int32)) - 1
        slot = jnp.where(keep, dest, H)
        w = jnp.where(keep, (hit_rpos << 9) | hit_len, 0)
        hit_w_c = jnp.zeros(H + 1, dtype=jnp.int32).at[slot].set(
            w, mode="drop")[:H]
        hit_loc_c = jnp.zeros(H + 1, dtype=jnp.int32).at[slot].set(
            jnp.where(keep, hit_loc, 0), mode="drop")[:H]
        counts = jnp.zeros(B, dtype=jnp.int32).at[hit_read].add(
            keep.astype(jnp.int32))
        counts2 = (counts[0::2] & 0xFFFF) | (counts[1::2] << 16)
        total_kept = keep.sum()

        ovf_bits = jnp.zeros(B // 32, dtype=jnp.int32).at[
            jnp.arange(B) >> 5].add(
            overflow.astype(jnp.int32) << (jnp.arange(B) & 31))
        return jnp.concatenate([
            hit_w_c, hit_loc_c, counts2, ovf_bits,
            jnp.stack([total_kept, buffer_overflow.astype(jnp.int32)]),
        ])

    jitted = jax.jit(kernel)

    def submit(packed, rlens):
        dev = jitted(fm_template, packed, rlens)
        try:
            dev.copy_to_host_async()
        except Exception:
            pass
        return dev

    def collect(dev_packed):
        p = np.asarray(dev_packed)
        B = batch
        hit_w = p[0:H]
        hit_loc = p[H:2 * H]
        c2 = p[2 * H:2 * H + B // 2]
        counts = np.empty(B, dtype=np.int32)
        counts[0::2] = c2 & 0xFFFF
        counts[1::2] = (c2 >> 16) & 0xFFFF
        nov = B // 32
        ovf_bits = p[2 * H + B // 2:2 * H + B // 2 + nov]
        total = int(p[-2])
        buf_ovf = bool(p[-1])
        bit = (np.arange(B) & 31)
        overflow = ((ovf_bits[np.arange(B) >> 5] >> bit) & 1).astype(bool)
        n = min(total, H)
        rpos = (hit_w[:n] >> 9) & 0x1FF
        lens = hit_w[:n] & 0x1FF
        return counts, rpos, hit_loc[:n].astype(np.int64), lens, overflow, buf_ovf

    submit.collect = collect
    submit.H = H
    submit.raw_kernel = kernel   # traceable: (fm, packed, rlens) -> packed vec
    return submit


def build_seed_chain_kernel(fm_template, chain_ctx, max_len: int, batch: int,
                            slow_hits_x4: int = 5, with_planes: bool = False,
                            pair_end: bool = False, compact_lanes: int = 0):
    """Seeding + device chaining/classification in one jitted graph
    (see ops/chain_device.py). Output int32 vector:

      [meta1[B]  : cls | mm<<2 | rplast<<8 | cscore<<17,
       pd[B]     : the single diagonal of FAST reads,
       hit_w[H2] : rpos<<9|len for SLOW reads' hits only,
       hit_loc[H2], counts2[B/2] (slow reads; fast/nocand get 0),
       ovfbits[B/32], total_slow_kept, buffer_overflow]

    Fast/nocand reads transfer 8 bytes instead of their hits, and the
    host skips chaining + alignment for them entirely.

    with_planes=True folds the evidence apply into this dispatch: the
    kernel takes the HBM evidence planes (donated) and speculatively
    scatters every device-classified FAST read's evidence — the host
    later retracts the few it rejects (duplicate gate, oracle splices)
    via device_profile.build_correct_kernel. XLA fuses the scatter with
    the classification pass, removing the separate apply dispatch and
    its re-read of pd/mmp from HBM; pair_end picks the orientation
    plane by batch-index parity (mates interleave even/odd)."""
    from .chain_device import CLASS_FAST, CLASS_SLOW, ChainCtx, classify_reads
    from .evidence import scatter_fast_evidence
    from .fm3_device import DeviceFM3
    assert batch % 32 == 0 and max_len <= 511
    max_seeds = max_len // (MIN_SEED_LEN + 1) + 2
    H = batch * max(9, slow_hits_x4) // 4   # raw hit expansion capacity
    H2 = batch * slow_hits_x4 // 4          # compacted slow-hit capacity
    use_occ3 = isinstance(fm_template, DeviceFM3)

    def kernel(fm, ctx: ChainCtx, packed: jnp.ndarray, rlens: jnp.ndarray,
               planes=None):
        B = batch
        W4 = packed.shape[1]
        nwords = (W4 + 3) // 4
        pb = packed.astype(jnp.uint32).reshape(B, nwords, 4)
        sh = (jnp.arange(4, dtype=jnp.uint32) * 8)[None, None, :]
        bwa_sh = (jnp.arange(4, dtype=jnp.uint32) * 8)
        # little-endian byte assembly for codes_fn (matches packed layout)
        words_le = (pb << sh).sum(axis=2, dtype=jnp.uint32)
        widx = jnp.arange(nwords, dtype=jnp.int32)[None, :]

        def codes_fn(row, pos):
            wi = (pos >> 4)[:, None]
            w = jnp.where(widx == wi, words_le, 0).sum(axis=1, dtype=jnp.uint32)
            return ((w >> ((pos.astype(jnp.uint32) & 15) * 2)) & 3
                    ).astype(jnp.int32)


        def key_fn(row, pos):
            wi = pos >> 4
            w0 = jnp.where(widx == wi[:, None], words_le, 0).sum(
                axis=1, dtype=jnp.uint32)
            w1 = jnp.where(widx == (wi + 1)[:, None], words_le, 0).sum(
                axis=1, dtype=jnp.uint32)
            sh = ((pos & 15) * 2).astype(jnp.uint32)
            lo = w0 >> sh
            hi = jnp.where(sh > 0, w1 << (jnp.uint32(32) - sh),
                           jnp.uint32(0))
            comb = lo | hi
            KK = fm_template.pfx_k
            key = jnp.zeros_like(pos)
            for j in range(KK):
                key = key | (((comb >> jnp.uint32(2 * j)) & 3
                              ).astype(jnp.int32) << (2 * (KK - 1 - j)))
            return key

        kf = key_fn if (use_occ3 and getattr(fm_template, "pfx_k", 0)) else None

        if use_occ3 and compact_lanes and compact_lanes < B:
            # lane-compacted scan (cost ~ mean trajectory, not max);
            # the fused prefix-skip engages automatically (fm.pfx_base)
            (n_seeds, s_rpos, s_len, s_x0, s_freq, overflow) = \
                _seed_scan3_compact(fm, words_le, rlens, B, compact_lanes,
                                    max_len, max_seeds)
        elif use_occ3:
            (n_seeds, s_rpos, s_len, s_x0, s_freq, overflow) = _seed_scan3(
                fm, codes_fn, rlens, B, max_len, max_seeds, key_fn=kf)
        else:
            (n_seeds, s_rpos, s_len, s_x0, s_freq, overflow) = _seed_scan(
                fm, codes_fn, rlens, B, max_len, max_seeds, has_n=False)

        sidx = jnp.arange(max_seeds, dtype=jnp.int32)[None, :]
        seed_valid = sidx < n_seeds[:, None]
        freqs = jnp.where(seed_valid, s_freq, 0).reshape(-1)
        x0s = s_x0.reshape(-1)
        rposs = s_rpos.reshape(-1)
        lens = s_len.reshape(-1)
        readix = jnp.repeat(jnp.arange(B, dtype=jnp.int32), max_seeds)

        total_raw = freqs.sum()
        csum = jnp.cumsum(freqs) - freqs
        hpos = jnp.arange(H, dtype=jnp.int32)
        seg_start = jnp.repeat(csum, freqs, total_repeat_length=H)
        within = hpos - seg_start
        hit_row = jnp.repeat(x0s, freqs, total_repeat_length=H) + within
        hit_rpos = jnp.repeat(rposs, freqs, total_repeat_length=H)
        hit_len = jnp.repeat(lens, freqs, total_repeat_length=H)
        hit_read = jnp.repeat(readix, freqs, total_repeat_length=H)
        hit_valid = hpos < jnp.minimum(total_raw, H)
        buffer_overflow = total_raw > H

        fm1 = fm.fm if use_occ3 else fm
        hit_loc, resolved = sa_resolve(fm1, jnp.where(hit_valid, hit_row, 32),
                                       hit_valid)
        unresolved_read = jnp.zeros(B, dtype=jnp.int32).at[hit_read].max(
            (hit_valid & ~resolved).astype(jnp.int32))
        overflow = overflow | (unresolved_read > 0)

        keep = hit_valid & ((hit_loc - hit_rpos) > 0)

        # read words in bwa crumb order for the diagonal compare: base j
        # of the read at bits (15 - j%16)*2 of word j//16
        pb2 = packed.astype(jnp.uint32)
        crumb = jnp.stack([(pb2 >> jnp.uint32(q * 2)) & 3 for q in range(4)],
                          axis=-1).reshape(B, W4 * 4)       # [B, max_len]
        cshift = jnp.asarray(((15 - (np.arange(max_len) & 15)) * 2)
                             .astype(np.uint32))
        cw = (crumb[:, :max_len] << cshift[None, :]).reshape(B, nwords, 16)
        words_bwa = cw.sum(axis=2, dtype=jnp.uint32)

        cls, pd0, mm, rplast, cscore, mmp = classify_reads(
            ctx, words_bwa, rlens, hit_read, hit_rpos, hit_len, hit_loc,
            keep, max_len)
        # per-read seed-table overflow forces the host-oracle path
        cls = jnp.where(unresolved_read > 0, CLASS_SLOW, cls)

        meta1 = cls | (mm << 2) | (rplast << 8) | (cscore << 17)

        keep_slow = keep & (cls[jnp.clip(hit_read, 0, B - 1)] == CLASS_SLOW)
        dest = jnp.cumsum(keep_slow.astype(jnp.int32)) - 1
        slot = jnp.where(keep_slow, dest, H2)
        w = jnp.where(keep_slow, (hit_rpos << 9) | hit_len, 0)
        hit_w_c = jnp.zeros(H2 + 1, dtype=jnp.int32).at[slot].set(
            w, mode="drop")[:H2]
        hit_loc_c = jnp.zeros(H2 + 1, dtype=jnp.int32).at[slot].set(
            jnp.where(keep_slow, hit_loc, 0), mode="drop")[:H2]
        counts = jnp.zeros(B, dtype=jnp.int32).at[hit_read].add(
            keep_slow.astype(jnp.int32), mode="drop")
        counts2 = (counts[0::2] & 0xFFFF) | (counts[1::2] << 16)
        total_kept = keep_slow.sum()
        buffer_overflow = buffer_overflow | (total_kept > H2)

        ovf_bits = jnp.zeros(B // 32, dtype=jnp.int32).at[
            jnp.arange(B) >> 5].add(
            overflow.astype(jnp.int32) << (jnp.arange(B) & 31))
        packed_out = jnp.concatenate([
            meta1, pd0, hit_w_c, hit_loc_c, counts2, ovf_bits,
            jnp.stack([total_kept, buffer_overflow.astype(jnp.int32)]),
        ])
        # pd/mmp stay device-resident for the evidence kernel
        # (pipeline/device_profile.py); only packed_out is downloaded
        if not with_planes:
            return packed_out, pd0, mmp

        # folded speculative evidence apply (see docstring)
        two_l = ctx.seq_len
        L = two_l // 2
        bidx = jnp.arange(B, dtype=jnp.int32)
        if pair_end:
            b_first = (bidx & 1) == 0
        else:
            b_first = jnp.ones(B, bool)
        exact, fd, acgt = scatter_fast_evidence(
            planes.exact_diff, planes.f_diff.reshape(-1),
            planes.acgt.reshape(-1), cls == CLASS_FAST, pd0, mmp, rlens,
            b_first, L, two_l, sign=1)
        from ..pipeline.device_profile import DevicePlanes
        planes_out = DevicePlanes(acgt=acgt.reshape(4, L + 1),
                                  exact_diff=exact,
                                  f_diff=fd.reshape(4, L + 2),
                                  multi_diff=planes.multi_diff, L=L)
        return packed_out, pd0, mmp, planes_out

    if with_planes:
        jitted = jax.jit(kernel, donate_argnums=(4,))

        def submit(packed, rlens, planes):
            dev, pd_dev, mmp_dev, planes_out = jitted(
                fm_template, chain_ctx, packed, rlens, planes)
            try:
                dev.copy_to_host_async()
            except Exception:
                pass
            return dev, pd_dev, mmp_dev, planes_out

    else:
        jitted = jax.jit(kernel)

        def submit(packed, rlens):
            dev, pd_dev, mmp_dev = jitted(fm_template, chain_ctx, packed,
                                          rlens)
            try:
                dev.copy_to_host_async()
            except Exception:
                pass
            return dev, pd_dev, mmp_dev

    def collect(dev_packed):
        p = np.asarray(dev_packed)
        B = batch
        meta1 = p[0:B]
        pd0 = p[B:2 * B]
        o = 2 * B
        hit_w = p[o:o + H2]
        hit_loc = p[o + H2:o + 2 * H2]
        o += 2 * H2
        c2 = p[o:o + B // 2]
        counts = np.empty(B, dtype=np.int32)
        counts[0::2] = c2 & 0xFFFF
        counts[1::2] = (c2 >> 16) & 0xFFFF
        o += B // 2
        ovf_bits = p[o:o + B // 32]
        total = int(p[-2])
        buf_ovf = bool(p[-1])
        bit = (np.arange(B) & 31)
        overflow = ((ovf_bits[np.arange(B) >> 5] >> bit) & 1).astype(bool)
        n = min(total, H2)
        rpos = (hit_w[:n] >> 9) & 0x1FF
        lens = hit_w[:n] & 0x1FF
        cls = meta1 & 3
        mm = (meta1 >> 2) & 0x3F
        rplast = (meta1 >> 8) & 0x1FF
        cscore = (meta1 >> 17) & 0x1FF
        return (cls, pd0, mm, rplast, cscore, counts, rpos,
                hit_loc[:n].astype(np.int64), lens, overflow, buf_ovf)

    submit.collect = collect
    submit.H2 = H2
    submit.raw_kernel = kernel
    submit.with_planes = with_planes
    return submit


def _seed_scan(fm, codes_fn, rlens, B, max_len, max_seeds, has_n):
    """Shared greedy-MEM state machine (see build_seed_kernel docstring).
    codes_fn(row, pos) -> int32 code; with has_n=False the ambiguity
    branch is compiled out (packed 2-bit input)."""
    L2 = fm.L2
    primary = fm.primary

    def step(state):
        (pos, in_ext, start, ext_pos, x0, x1, x2,
         n_seeds, s_rpos, s_len, s_x0, s_freq, overflow) = state
        bidx = jnp.arange(B, dtype=jnp.int32)
        stop_pos = rlens - MIN_SEED_LEN
        done = (~in_ext) & (pos >= stop_pos)
        active = ~done

        cpos = codes_fn(bidx, jnp.minimum(pos, max_len - 1))
        if has_n:
            start_new = active & (~in_ext) & (cpos <= 3)
            skip_amb = active & (~in_ext) & (cpos > 3)
        else:
            start_new = active & (~in_ext)
            skip_amb = jnp.zeros_like(start_new)

        cext = codes_fn(bidx, jnp.minimum(ext_pos, max_len - 1))
        ext_active = active & in_ext
        if has_n:
            at_end = ext_active & ((ext_pos >= rlens) | (cext > 3))
        else:
            at_end = ext_active & (ext_pos >= rlens)
        extending = ext_active & ~at_end

        k1 = jnp.where(extending, x1 - 1, 0)
        k2 = jnp.where(extending, x1 - 1 + x2, 0)
        tkl = occ4(fm, jnp.stack([k1, k2]))
        tk, tl = tkl[0], tkl[1]
        ok_x1 = L2[:4][None, :] + 1 + tk
        ok_x2 = tl - tk
        adj = ((x1 <= primary) & (x1 + x2 - 1 >= primary)).astype(x0.dtype)
        ok3_x0 = x0 + adj
        ok2_x0 = ok3_x0 + ok_x2[:, 3]
        ok1_x0 = ok2_x0 + ok_x2[:, 2]
        ok0_x0 = ok1_x0 + ok_x2[:, 1]
        ok_x0 = jnp.stack([ok0_x0, ok1_x0, ok2_x0, ok3_x0], axis=-1)
        ci = jnp.where(extending, 3 - cext, 0)
        onehot_c = (jnp.arange(4, dtype=jnp.int32)[None, :] == ci[:, None])
        new_x0 = jnp.where(onehot_c, ok_x0, 0).sum(axis=-1)
        new_x1 = jnp.where(onehot_c, ok_x1, 0).sum(axis=-1)
        new_x2 = jnp.where(onehot_c, ok_x2, 0).sum(axis=-1)
        ext_fail = extending & (new_x2 == 0)
        ext_ok = extending & (new_x2 != 0)

        finalize = at_end | ext_fail
        slen = ext_pos - start
        good = finalize & (slen >= MIN_SEED_LEN) & (x2 <= OCC_THR)
        slot = jnp.minimum(n_seeds, max_seeds - 1)
        overflow = overflow | (finalize & good & (n_seeds >= max_seeds))

        onehot = (jnp.arange(max_seeds, dtype=jnp.int32)[None, :] == slot[:, None]
                  ) & good[:, None]

        def put(arr, val):
            return jnp.where(onehot, val[:, None], arr)

        s_rpos = put(s_rpos, start)
        s_len = put(s_len, slen)
        s_x0 = put(s_x0, x0)
        s_freq = put(s_freq, x2)
        n_seeds = jnp.where(good, jnp.minimum(n_seeds + 1, max_seeds), n_seeds)

        pos = jnp.where(skip_amb, pos + 1,
              jnp.where(finalize, start + slen + 1, pos))
        x0 = jnp.where(start_new, L2[cpos & 3] + 1, jnp.where(ext_ok, new_x0, x0))
        x1 = jnp.where(start_new, L2[(3 - cpos) & 3] + 1, jnp.where(ext_ok, new_x1, x1))
        x2 = jnp.where(start_new, L2[(cpos & 3) + 1] - L2[cpos & 3],
                       jnp.where(ext_ok, new_x2, x2))
        start = jnp.where(start_new, pos, start)
        ext_pos = jnp.where(start_new, pos + 1, jnp.where(ext_ok, ext_pos + 1, ext_pos))
        in_ext = jnp.where(start_new, True, jnp.where(finalize, False, in_ext))

        return (pos, in_ext, start, ext_pos, x0, x1, x2,
                n_seeds, s_rpos, s_len, s_x0, s_freq, overflow)

    z = rlens * 0
    zb = z != 0
    zs = jnp.zeros((B, max_seeds), dtype=jnp.int32) + z[:, None]
    state = (z, zb, z, z, z, z, z, z, zs, zs, zs, zs, zb)
    n_iters = max_len + 2 * max_seeds + 2
    # Early-exit while_loop over 16-step unrolled blocks: every read is
    # done after ~rlen + 2*seeds steps, so short reads stop early, and
    # the device-side cond costs one reduction per 16 gathers-steps.
    UNROLL = 16
    n_blocks = (n_iters + UNROLL - 1) // UNROLL

    def block_cond(carry):
        i, s = carry
        pos, in_ext = s[0], s[1]
        active = in_ext | (pos < rlens - MIN_SEED_LEN)
        return (i < n_blocks) & jnp.any(active)

    def block_body(carry):
        i, s = carry
        for _ in range(UNROLL):
            s = step(s)
        return i + 1, s

    _, state = jax.lax.while_loop(block_cond, block_body, (jnp.int32(0), state))
    (_, _, _, _, _, _, _, n_seeds, s_rpos, s_len, s_x0, s_freq,
     overflow) = state
    return n_seeds, s_rpos, s_len, s_x0, s_freq, overflow


def build_seed_kernel(fm_template: DeviceFMIndex, max_len: int, batch: int,
                      hits_per_read: int = 8):
    """Returns jitted fn: (codes uint8[B,L], rlens int32[B]) ->
    (hit_read, hit_rpos, hit_len, hit_loc, hit_valid, n_hits, overflow).

    The index is passed as a jit argument (donated to HBM once by JAX's
    arg caching), not closed over, so the compiled binary doesn't embed
    multi-MB constants."""
    assert batch <= 8192 and max_len <= 511, "meta packing limits"
    max_seeds = max_len // (MIN_SEED_LEN + 1) + 2
    H = batch * hits_per_read

    def step(fm, state):
        L2 = fm.L2
        primary = fm.primary
        (pos, in_ext, start, ext_pos, x0, x1, x2,
         n_seeds, s_rpos, s_len, s_x0, s_freq, overflow, codes, rlens) = state
        B = pos.shape[0]
        bidx = jnp.arange(B, dtype=jnp.int32)
        stop_pos = rlens - MIN_SEED_LEN
        done = (~in_ext) & (pos >= stop_pos)
        active = ~done

        # ---- case A: start new extension or skip ambiguous base
        cpos = codes[bidx, jnp.minimum(pos, max_len - 1)].astype(jnp.int32)
        start_new = active & (~in_ext) & (cpos <= 3)
        skip_amb = active & (~in_ext) & (cpos > 3)

        # ---- case B: extension step
        cext = codes[bidx, jnp.minimum(ext_pos, max_len - 1)].astype(jnp.int32)
        ext_active = active & in_ext
        at_end = ext_active & ((ext_pos >= rlens) | (cext > 3))
        extending = ext_active & ~at_end

        # two batched occ4 lookups fused into one (bwt_2occ4 equivalent)
        k1 = jnp.where(extending, x1 - 1, 0)
        k2 = jnp.where(extending, x1 - 1 + x2, 0)
        tkl = occ4(fm, jnp.stack([k1, k2]))      # [2,B,4]
        tk, tl = tkl[0], tkl[1]
        ok_x1 = L2[:4][None, :] + 1 + tk         # [B,4]
        ok_x2 = tl - tk
        adj = ((x1 <= primary) & (x1 + x2 - 1 >= primary)).astype(x0.dtype)
        ok3_x0 = x0 + adj
        ok2_x0 = ok3_x0 + ok_x2[:, 3]
        ok1_x0 = ok2_x0 + ok_x2[:, 2]
        ok0_x0 = ok1_x0 + ok_x2[:, 1]
        ok_x0 = jnp.stack([ok0_x0, ok1_x0, ok2_x0, ok3_x0], axis=-1)
        ci = jnp.where(extending, 3 - cext, 0)
        onehot_c = (jnp.arange(4, dtype=jnp.int32)[None, :] == ci[:, None])
        new_x0 = jnp.where(onehot_c, ok_x0, 0).sum(axis=-1)
        new_x1 = jnp.where(onehot_c, ok_x1, 0).sum(axis=-1)
        new_x2 = jnp.where(onehot_c, ok_x2, 0).sum(axis=-1)
        ext_fail = extending & (new_x2 == 0)
        ext_ok = extending & (new_x2 != 0)

        finalize = at_end | ext_fail
        slen = ext_pos - start
        good = finalize & (slen >= MIN_SEED_LEN) & (x2 <= OCC_THR)
        slot = jnp.minimum(n_seeds, max_seeds - 1)
        overflow = overflow | (finalize & good & (n_seeds >= max_seeds))

        # one-hot select instead of a scatter
        onehot = (jnp.arange(max_seeds, dtype=jnp.int32)[None, :] == slot[:, None]
                  ) & good[:, None]

        def put(arr, val):
            return jnp.where(onehot, val[:, None], arr)

        s_rpos = put(s_rpos, start)
        s_len = put(s_len, slen)
        s_x0 = put(s_x0, x0)
        s_freq = put(s_freq, x2)
        n_seeds = jnp.where(good, jnp.minimum(n_seeds + 1, max_seeds), n_seeds)

        # ---- state updates
        pos = jnp.where(skip_amb, pos + 1,
              jnp.where(finalize, start + slen + 1, pos))
        x0 = jnp.where(start_new, L2[cpos & 3] + 1, jnp.where(ext_ok, new_x0, x0))
        x1 = jnp.where(start_new, L2[(3 - cpos) & 3] + 1, jnp.where(ext_ok, new_x1, x1))
        x2 = jnp.where(start_new, L2[(cpos & 3) + 1] - L2[cpos & 3],
                       jnp.where(ext_ok, new_x2, x2))
        start = jnp.where(start_new, pos, start)
        ext_pos = jnp.where(start_new, pos + 1, jnp.where(ext_ok, ext_pos + 1, ext_pos))
        in_ext = jnp.where(start_new, True, jnp.where(finalize, False, in_ext))

        return (pos, in_ext, start, ext_pos, x0, x1, x2,
                n_seeds, s_rpos, s_len, s_x0, s_freq, overflow, codes, rlens)

    def kernel(fm: DeviceFMIndex, codes: jnp.ndarray, rlens: jnp.ndarray):
        B = batch
        # derive initial state from the inputs so every carry component
        # has the same device-varying type under shard_map
        z = rlens * 0
        zb = z != 0
        zs = jnp.zeros((B, max_seeds), dtype=jnp.int32) + z[:, None]
        state = (z, zb, z, z, z, z, z, z, zs, zs, zs, zs, zb, codes, rlens)
        # fixed trip count: every iteration advances pos or ext_pos except
        # seed finalization (bounded by max_seeds) — a data-dependent
        # while cond would sync with the host each iteration.
        n_iters = max_len + 2 * max_seeds + 2
        state = jax.lax.fori_loop(0, n_iters, lambda _, s: step(fm, s), state)
        (_, _, _, _, _, _, _, n_seeds, s_rpos, s_len, s_x0, s_freq,
         overflow, _, _) = state

        # mask seeds beyond n_seeds
        sidx = jnp.arange(max_seeds, dtype=jnp.int32)[None, :]
        seed_valid = sidx < n_seeds[:, None]
        freqs = jnp.where(seed_valid, s_freq, 0).reshape(-1)
        x0s = s_x0.reshape(-1)
        rposs = s_rpos.reshape(-1)
        lens = s_len.reshape(-1)
        readix = jnp.repeat(jnp.arange(B, dtype=jnp.int32), max_seeds)

        total = freqs.sum()
        csum = jnp.cumsum(freqs) - freqs                 # exclusive
        hit_pos = jnp.arange(H, dtype=jnp.int32)
        seg_start = jnp.repeat(csum, freqs, total_repeat_length=H)
        within = hit_pos - seg_start
        hit_row = jnp.repeat(x0s, freqs, total_repeat_length=H) + within
        hit_rpos = jnp.repeat(rposs, freqs, total_repeat_length=H)
        hit_len = jnp.repeat(lens, freqs, total_repeat_length=H)
        hit_read = jnp.repeat(readix, freqs, total_repeat_length=H)
        hit_valid = hit_pos < jnp.minimum(total, H)
        buffer_overflow = total > H   # batch-level: hits truncated

        hit_loc, resolved = sa_resolve(fm, jnp.where(hit_valid, hit_row, 32),
                                       hit_valid)
        # reads owning an unresolved hit fall back to the host oracle
        unresolved_read = jnp.zeros(B, dtype=jnp.int32).at[hit_read].max(
            (hit_valid & ~resolved).astype(jnp.int32))
        overflow = overflow | (unresolved_read > 0)
        # pack everything into ONE compact int32 vector: one D2H per
        # batch, few bytes. meta word =
        # read_idx << 18 | rpos << 9 | len (len == 0 <=> invalid slot).
        meta = jnp.where(hit_valid,
                         (hit_read << 18) | (hit_rpos << 9) | hit_len,
                         0)
        ovf_bits = jnp.zeros((B + 31) // 32, dtype=jnp.int32).at[
            jnp.arange(B) >> 5].add(
            overflow.astype(jnp.int32) << (jnp.arange(B) & 31))
        packed = jnp.concatenate([
            meta, hit_loc, ovf_bits,
            jnp.stack([total, buffer_overflow.astype(jnp.int32)]),
        ])
        return packed

    jitted = jax.jit(kernel)

    def submit(codes, rlens):
        """Enqueue the kernel (async dispatch); returns the device array."""
        return jitted(fm_template, codes, rlens)

    def collect(dev_packed):
        packed = np.asarray(dev_packed)
        return _unpack(packed)

    def fn(codes, rlens):
        return _unpack(np.asarray(jitted(fm_template, codes, rlens)))

    def _unpack(packed):
        meta = packed[0:H]
        hit_loc = packed[H:2 * H]
        nov = (batch + 31) // 32
        ovf_bits = packed[2 * H:2 * H + nov]
        total = int(packed[2 * H + nov])
        buf_ovf = bool(packed[2 * H + nov + 1])
        hit_len = meta & 0x1FF
        hit_rpos = (meta >> 9) & 0x1FF
        hit_read = meta >> 18
        hit_valid = hit_len > 0
        bit = (np.arange(batch) & 31)
        overflow = ((ovf_bits[np.arange(batch) >> 5] >> bit) & 1).astype(bool)
        return (hit_read, hit_rpos, hit_len, hit_loc, hit_valid, total,
                overflow, buf_ovf)

    fn.raw_kernel = kernel   # traceable: (fm, codes, rlens) -> packed int32
    fn.H = H
    fn.batch = batch
    fn.submit = submit
    fn.collect = collect
    return fn


def seeds_to_frag_pairs(hit_read: np.ndarray, hit_rpos: np.ndarray,
                        hit_len: np.ndarray, hit_loc: np.ndarray,
                        hit_valid: np.ndarray, batch: int,
                        two_genome_size: int) -> List[list]:
    """Host post-processing: per-read sorted FragPair lists with sentinel
    (mirrors IdentifySimplePairs ordering, ReadMapping.cpp:152-155)."""
    from ..pipeline.seeding import FragPair
    out: List[list] = [[] for _ in range(batch)]
    v = hit_valid
    pd = hit_loc.astype(np.int64) - hit_rpos
    keep = v & (pd > 0)
    for b, rpos, ln, loc, d in zip(hit_read[keep], hit_rpos[keep],
                                   hit_len[keep], hit_loc[keep], pd[keep]):
        out[b].append(FragPair(True, int(rpos), int(loc), int(ln), int(ln), int(d)))
    for b in range(batch):
        out[b].sort(key=lambda f: (f.PosDiff, f.rPos))
        out[b].append(FragPair(True, 0, two_genome_size, 0, 0, two_genome_size))
    return out
