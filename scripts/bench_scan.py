#!/usr/bin/env python
"""Isolated seed-scan timing on the real device: lockstep vs lane-
compacted, across lane/batch shapes. Times ONLY the scan kernel (one
jit call per batch, reads pre-staged on device) so stream/transfer
effects don't confound the comparison. Names the device and fails
without a GPU; prints one JSON line per shape.

Usage: python scripts/bench_scan.py
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
    from mapcaller.io.fastq import iter_chunks
    from mapcaller.ops.fm3_device import DeviceFM3
    from mapcaller.ops.fm_search import (MIN_SEED_LEN, _seed_scan3,
                                             _seed_scan3_compact)

    bench.require_gpu()
    enable_compilation_cache()
    idx, r1, _ = bench.bench_index()
    fm3 = DeviceFM3.from_host(idx)
    MAXLEN = 128
    max_seeds = MAXLEN // (MIN_SEED_LEN + 1) + 2

    # load enough reads for the largest row (a row that slices past
    # the loaded reads would silently time fewer reads than it labels)
    want = 131072
    if os.environ.get("MC_SCAN_SHAPES"):
        want = max(want, *(int(t.split(":")[0])
                           for t in os.environ["MC_SCAN_SHAPES"].split(",")))
    reads = []
    for chunk in iter_chunks(r1, None):
        reads.extend(r.seq for r in chunk)
        if len(reads) >= want:
            break
    code = np.full(256, 0, np.uint8)
    for i, ch in enumerate("ACGT"):
        code[ord(ch)] = i
    NB = max(65536, want)
    mat = np.zeros((NB, MAXLEN), dtype=np.uint8)
    rlens = np.zeros(NB, dtype=np.int32)
    for j, s in enumerate(reads[:NB]):
        arr = code[np.frombuffer(s.encode(), np.uint8)][:MAXLEN]
        mat[j, :arr.size] = arr
        rlens[j] = arr.size
    packed = np.zeros((NB, MAXLEN // 4), dtype=np.uint8)
    for q in range(4):
        packed |= (mat[:, q::4] & 3) << (2 * q)
    nwords = MAXLEN // 16
    pb = packed.astype(np.uint32).reshape(NB, nwords, 4)
    sh = (np.arange(4, dtype=np.uint32) * 8)[None, None, :]
    words = (pb << sh).sum(axis=2, dtype=np.uint32)

    _ = np.asarray(jnp.zeros(8))   # honest-timing trigger

    def time_fn(fn, args, nrep=5):
        out = fn(*args)
        jax.block_until_ready(out)
        best = float("inf")
        for _ in range(nrep):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            best = min(best, time.perf_counter() - t0)
        return best

    results = []

    def lockstep_builder(B):
        @jax.jit
        def f(fm3, packed, rlens):
            pb = packed.astype(jnp.uint32).reshape(B, nwords, 4)
            shl = (jnp.arange(4, dtype=jnp.uint32) * 8)[None, None, :]
            w = (pb << shl).sum(axis=2, dtype=jnp.uint32)
            widx = jnp.arange(nwords, dtype=jnp.int32)[None, :]

            def codes_fn(row, pos):
                wi = (pos >> 4)[:, None]
                ww = jnp.where(widx == wi, w, 0).sum(axis=1,
                                                     dtype=jnp.uint32)
                return ((ww >> ((pos.astype(jnp.uint32) & 15) * 2)) & 3
                        ).astype(jnp.int32)

            return _seed_scan3(fm3, codes_fn, rlens, B, MAXLEN, max_seeds)
        return f

    def compact_builder(BT, lanes):
        @jax.jit
        def f(fm3, words, rlens):
            return _seed_scan3_compact(fm3, words, rlens, BT, lanes,
                                       MAXLEN, max_seeds)
        return f

    def lockstep_fused_builder(B, fm3f):
        KK = fm3f.pfx_k

        @jax.jit
        def f(fm3f, packed, rlens):
            pb = packed.astype(jnp.uint32).reshape(B, nwords, 4)
            shl = (jnp.arange(4, dtype=jnp.uint32) * 8)[None, None, :]
            w = (pb << shl).sum(axis=2, dtype=jnp.uint32)
            widx = jnp.arange(nwords, dtype=jnp.int32)[None, :]

            def codes_fn(row, pos):
                wi = (pos >> 4)[:, None]
                ww = jnp.where(widx == wi, w, 0).sum(axis=1,
                                                     dtype=jnp.uint32)
                return ((ww >> ((pos.astype(jnp.uint32) & 15) * 2)) & 3
                        ).astype(jnp.int32)

            def key_fn(row, pos):
                wi = pos >> 4
                w0 = jnp.where(widx == wi[:, None], w, 0).sum(
                    axis=1, dtype=jnp.uint32)
                w1 = jnp.where(widx == (wi + 1)[:, None], w, 0).sum(
                    axis=1, dtype=jnp.uint32)
                shp = ((pos & 15) * 2).astype(jnp.uint32)
                comb = (w0 >> shp) | jnp.where(
                    shp > 0, w1 << (jnp.uint32(32) - shp), jnp.uint32(0))
                key = jnp.zeros_like(pos)
                for j in range(KK):
                    key = key | (((comb >> jnp.uint32(2 * j)) & 3
                                  ).astype(jnp.int32) << (2 * (KK - 1 - j)))
                return key

            return _seed_scan3(fm3f, codes_fn, rlens, B, MAXLEN, max_seeds,
                               key_fn=key_fn)
        return f

    PFX = int(os.environ.get("MC_SCAN_PFX", "10"))
    fm3_fused = DeviceFM3.from_host(idx, fm3.fm, pfx_k=PFX) if PFX else None

    for B in (32768,):
        f = lockstep_builder(B)
        t = time_fn(f, (fm3, jnp.asarray(packed[:B]), jnp.asarray(rlens[:B])))
        results.append({"kind": "lockstep", "reads": B, "lanes": B,
                        "t_ms": round(t * 1e3, 2),
                        "reads_per_s": round(B / t)})
        print(json.dumps(results[-1]), flush=True)
        if fm3_fused is not None:
            f = lockstep_fused_builder(B, fm3_fused)
            t = time_fn(f, (fm3_fused, jnp.asarray(packed[:B]),
                            jnp.asarray(rlens[:B])))
            results.append({"kind": f"lockstep+pfx{PFX}", "reads": B,
                            "lanes": B, "t_ms": round(t * 1e3, 2),
                            "reads_per_s": round(B / t)})
            print(json.dumps(results[-1]), flush=True)
            for BT, lanes in ((65536, 32768), (131072, 32768)):
                f = compact_builder(BT, lanes)
                t = time_fn(f, (fm3_fused, jnp.asarray(words[:BT]),
                                jnp.asarray(rlens[:BT])))
                results.append({"kind": f"compact+pfx{PFX}", "reads": BT,
                                "lanes": lanes, "t_ms": round(t * 1e3, 2),
                                "reads_per_s": round(BT / t)})
                print(json.dumps(results[-1]), flush=True)

    shapes = ((65536, 32768), (32768, 16384), (65536, 16384),
              (32768, 32768))
    if os.environ.get("MC_SCAN_SHAPES"):
        shapes = tuple(tuple(int(x) for x in t.split(":"))
                       for t in os.environ["MC_SCAN_SHAPES"].split(","))
    for BT, lanes in shapes:
        f = compact_builder(BT, lanes)
        t = time_fn(f, (fm3, jnp.asarray(words[:BT]),
                        jnp.asarray(rlens[:BT])))
        results.append({"kind": "compact", "reads": BT, "lanes": lanes,
                        "t_ms": round(t * 1e3, 2),
                        "reads_per_s": round(BT / t)})
        print(json.dumps(results[-1]), flush=True)


if __name__ == "__main__":
    main()
