#!/usr/bin/env python
"""Per-leg timing of the production seed+chain kernel on the GPU:
cumulative variants isolate scan / hit-expansion
+SA-resolve / classify / output-packing so optimization lands where the
milliseconds are. All inputs pre-staged on device; every variant
returns reduced scalars so XLA cannot DCE the leg under test.

Usage: python scripts/bench_kernel_legs.py [reads [lanes]]
Names the device and fails without a GPU; prints the legs as JSON.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> None:
    import jax
    import jax.numpy as jnp

    import bench
    from mapcaller import enable_compilation_cache
    from mapcaller.config import Config
    from mapcaller.io.fastq import iter_chunks
    from mapcaller.ops.chain_device import classify_reads
    from mapcaller.ops.fm_device import sa_resolve
    from mapcaller.ops.fm_search import (MIN_SEED_LEN,
                                             _seed_scan3_compact)
    from mapcaller.pipeline.device_backend import DeviceBackend

    bench.require_gpu()
    enable_compilation_cache()
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 131072
    LANES = int(sys.argv[2]) if len(sys.argv) > 2 else 32768
    MAXLEN = 128
    max_seeds = MAXLEN // (MIN_SEED_LEN + 1) + 2
    H = B * 9 // 4

    idx, r1, _ = bench.bench_index()
    cfg = Config(batch_size=8192, max_read_len=MAXLEN)
    be = DeviceBackend(idx, cfg)
    fm3 = be.fm3          # production table incl. auto-selected pfx rows
    ctx = be.chain_ctx

    # ---- stage B reads on device (packed codes + LE words) -------------
    reads = []
    for chunk in iter_chunks(r1, None):
        reads.extend(r.seq for r in chunk)
        if len(reads) >= B:
            break
    code = np.zeros(256, np.uint8)
    for i, ch in enumerate("ACGT"):
        code[ord(ch)] = i
    mat = np.zeros((B, MAXLEN), dtype=np.uint8)
    rlens = np.zeros(B, dtype=np.int32)
    for j, s in enumerate(reads[:B]):
        arr = code[np.frombuffer(s.encode(), np.uint8)][:MAXLEN]
        mat[j, :arr.size] = arr
        rlens[j] = arr.size
    packed = np.zeros((B, MAXLEN // 4), dtype=np.uint8)
    for q in range(4):
        packed |= (mat[:, q::4] & 3) << (2 * q)
    nwords = MAXLEN // 16
    pb = packed.astype(np.uint32).reshape(B, nwords, 4)
    shl = (np.arange(4, dtype=np.uint32) * 8)[None, None, :]
    words = (pb << shl).sum(axis=2, dtype=np.uint32)
    d_words = jax.device_put(jnp.asarray(words))
    d_rlens = jax.device_put(jnp.asarray(rlens))
    d_packed = jax.device_put(jnp.asarray(packed))

    def scan(fm, w, r):
        return _seed_scan3_compact(fm, w, r, B, LANES, MAXLEN, max_seeds)

    def expand_resolve(fm, w, r):
        n_seeds, s_rpos, s_len, s_x0, s_freq, overflow = scan(fm, w, r)
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
        hit_loc, resolved = sa_resolve(
            fm.fm, jnp.where(hit_valid, hit_row, 32), hit_valid)
        keep = hit_valid & ((hit_loc - hit_rpos) > 0)
        return (hit_read, hit_rpos, hit_len, hit_loc, keep, overflow,
                n_seeds)

    def to_bwa_words(pk):
        pb2 = pk.astype(jnp.uint32)
        W4 = pk.shape[1]
        crumb = jnp.stack([(pb2 >> jnp.uint32(q * 2)) & 3
                           for q in range(4)], axis=-1).reshape(B, W4 * 4)
        cshift = jnp.asarray(((15 - (np.arange(MAXLEN) & 15)) * 2)
                             .astype(np.uint32))
        cw = (crumb[:, :MAXLEN] << cshift[None, :]).reshape(B, nwords, 16)
        return cw.sum(axis=2, dtype=jnp.uint32)

    def full_classify(fm, w, r, pk):
        (hit_read, hit_rpos, hit_len, hit_loc, keep, overflow,
         n_seeds) = expand_resolve(fm, w, r)
        words_bwa = to_bwa_words(pk)
        cls, pd0, mm, rplast, cscore, mmp = classify_reads(
            ctx, words_bwa, r, hit_read, hit_rpos, hit_len, hit_loc,
            keep, MAXLEN)
        return cls, pd0, mm, rplast, cscore, mmp, hit_read, keep, hit_loc

    def pack_out(fm, w, r, pk):
        (cls, pd0, mm, rplast, cscore, mmp, hit_read, keep,
         hit_loc) = full_classify(fm, w, r, pk)
        from mapcaller.ops.chain_device import CLASS_SLOW
        H2 = B * 5 // 4
        keep_slow = keep & (cls[jnp.clip(hit_read, 0, B - 1)] == CLASS_SLOW)
        dest = jnp.cumsum(keep_slow.astype(jnp.int32)) - 1
        slot = jnp.where(keep_slow, dest, H2)
        hit_loc_c = jnp.zeros(H2 + 1, dtype=jnp.int32).at[slot].set(
            jnp.where(keep_slow, hit_loc, 0), mode="drop")[:H2]
        counts = jnp.zeros(B, dtype=jnp.int32).at[hit_read].add(
            keep_slow.astype(jnp.int32), mode="drop")
        return (cls.sum(), pd0.sum(), hit_loc_c.sum(), counts.sum(),
                mmp.sum(), rplast.sum(), cscore.sum(), mm.sum())

    variants = {
        "scan": jax.jit(lambda fm, w, r, pk:
                        tuple(x.sum() for x in scan(fm, w, r))),
        "scan+resolve": jax.jit(
            lambda fm, w, r, pk:
            tuple(x.sum() for x in expand_resolve(fm, w, r))),
        "scan+resolve+classify": jax.jit(
            lambda fm, w, r, pk:
            tuple(x.sum() for x in full_classify(fm, w, r, pk)[:6])),
        "full(pack_out)": jax.jit(pack_out),
    }

    out = {"B": B, "lanes": LANES, "pfx_k": int(fm3.pfx_k)}
    prev = 0.0
    for name, fn in variants.items():
        jax.block_until_ready(fn(fm3, d_words, d_rlens, d_packed))
        best = float("inf")
        for _ in range(7):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(fm3, d_words, d_rlens, d_packed))
            best = min(best, time.perf_counter() - t0)
        out[name] = {"t_ms": round(best * 1e3, 2),
                     "t_ms_per_32k": round(best * 1e3 * 32768 / B, 2),
                     "leg_ms": round((best - prev) * 1e3, 2)}
        prev = best
        print(name, out[name], flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
