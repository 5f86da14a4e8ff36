#!/usr/bin/env python
"""Measure the seed-scan's per-lane trajectory-length distribution on
the real bench workload (VERDICT r2 weak #2): the lockstep scan costs
the MAX lane trajectory per batch; lane compaction/refill would cost
~the MEAN. mean/max across batches bounds the achievable speedup.

CPU run (iteration counts are platform-independent).
Usage: python scripts/measure_lane_traj.py [n_batches]
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np


def main() -> None:
    import jax.numpy as jnp

    from mapcaller.io.fastq import iter_chunks
    from mapcaller.ops.fm3_device import DeviceFM3
    from mapcaller.ops.fm_search import MIN_SEED_LEN, _seed_scan3

    n_batches = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    import bench
    idx, r1, _ = bench.bench_index()
    fm3 = DeviceFM3.from_host(idx)

    B, MAXLEN = 8192, 128
    max_seeds = MAXLEN // (MIN_SEED_LEN + 1) + 2

    @jax.jit
    def scan(fm3, packed, rlens):
        W4 = packed.shape[1]
        nwords = (W4 + 3) // 4
        pb = packed.astype(jnp.uint32).reshape(B, nwords, 4)
        sh = (jnp.arange(4, dtype=jnp.uint32) * 8)[None, None, :]
        words = (pb << sh).sum(axis=2, dtype=jnp.uint32)
        widx = jnp.arange(nwords, dtype=jnp.int32)[None, :]

        def codes_fn(row, pos):
            wi = (pos >> 4)[:, None]
            w = jnp.where(widx == wi, words, 0).sum(axis=1,
                                                    dtype=jnp.uint32)
            return ((w >> ((pos.astype(jnp.uint32) & 15) * 2)) & 3
                    ).astype(jnp.int32)

        out = _seed_scan3(fm3, codes_fn, rlens, B, MAXLEN, max_seeds,
                          with_iters=True)
        return out[-1]

    reads = []
    for chunk in iter_chunks(r1, None):
        for r in chunk:
            reads.append(r.seq)
        if len(reads) >= n_batches * B:
            break
    code = np.full(256, 0, np.uint8)
    for i, ch in enumerate("ACGT"):
        code[ord(ch)] = i

    stats = []
    for bi in range(n_batches):
        batch = reads[bi * B:(bi + 1) * B]
        mat = np.zeros((B, MAXLEN), dtype=np.uint8)
        rlens = np.zeros(B, dtype=np.int32)
        for j, s in enumerate(batch):
            arr = code[np.frombuffer(s.encode(), np.uint8)][:MAXLEN]
            mat[j, :arr.size] = arr
            rlens[j] = arr.size
        packed = np.zeros((B, MAXLEN // 4), dtype=np.uint8)
        for q in range(4):
            packed |= (mat[:, q::4] & 3) << (2 * q)
        iters = np.asarray(scan(fm3, jnp.asarray(packed),
                                jnp.asarray(rlens)))
        stats.append({
            "mean": float(iters.mean()), "max": int(iters.max()),
            "p50": int(np.percentile(iters, 50)),
            "p90": int(np.percentile(iters, 90)),
            "p99": int(np.percentile(iters, 99)),
            "p999": int(np.percentile(iters, 99.9)),
        })
        print(json.dumps(stats[-1]), flush=True)

    mean = float(np.mean([s["mean"] for s in stats]))
    mx = float(np.mean([s["max"] for s in stats]))
    print(json.dumps({"batches": n_batches, "lanes": B,
                      "mean_traj": round(mean, 1),
                      "max_traj": round(mx, 1),
                      "compaction_upper_bound_speedup":
                          round(mx / mean, 2)}))


if __name__ == "__main__":
    main()
