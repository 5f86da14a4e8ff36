#!/usr/bin/env python
""">2^31-row big-genome proof: build a synthetic
1.1 Gbp genome (fwd+rc text = 2.2e9 rows > 2^31), build the int64
index artifacts + shard-relative occ3 table, run the x64 sharded
seeding+SA kernel (parallel/big_index.py) on the 8-device virtual CPU
mesh, and verify bit-exactness against the host FM-index oracle.

Prints the result as JSON. Host-RAM heavy (~80 GB peak) and ~30 min of
wall clock — run standalone, not under pytest. Scratch files go to the
git-ignored `.bench_data/biggenome/`.
"""
import gc
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# run on the virtual 8-device CPU mesh
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
import jax  # noqa: E402

L = int(os.environ.get("MC_BIG_L", 1_100_000_000))
# default 1.1 Gbp -> n = 2.2e9 rows > 2^31; MC_BIG_L overrides for smokes
N_DEV = 8
B = 16                     # reads per device
MAXLEN = 112
RLEN = 100
SCRATCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".bench_data", "biggenome")


def rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg} (rss {rss_gb():.1f} GB)",
          flush=True)


def main() -> None:
    import numpy as np

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mapcaller.index.fmindex import build_index
    from mapcaller.index.occ3 import build_occ3_64
    from mapcaller.index.packer import PackedReference
    from mapcaller.ops.fm_search import MIN_SEED_LEN, OCC_THR
    from mapcaller.parallel.big_index import build_big_seed_hits_kernel
    from mapcaller.parallel.mesh import make_mesh

    os.makedirs(SCRATCH, exist_ok=True)
    out = {"genome_bp": L, "text_rows": 2 * L,
           "exceeds_int32": 2 * L > 2**31}
    t_all = time.time()

    rng = np.random.default_rng(1234)
    log("generating genome")
    codes = np.empty(L, dtype=np.uint8)
    CH = 1 << 26
    for lo in range(0, L, CH):
        codes[lo:lo + CH] = rng.integers(0, 4, size=min(CH, L - lo),
                                         dtype=np.int64).astype(np.uint8)
    ref = PackedReference(["chrBig"], [L], [0], codes, [])

    log("building int64 index artifacts (SA-IS + streaming BWT)")
    t0 = time.time()
    idx = build_index(None, packed=ref, keep_sa64=True)
    out["index_build_s"] = round(time.time() - t0, 1)
    assert idx.sa_full is not None
    if idx.sa_full.dtype != np.int64:   # small-L smoke runs
        idx.sa_full = idx.sa_full.astype(np.int64)
    assert idx.seq_len == 2 * L
    out["primary"] = int(idx.primary)
    text = ref.fwd_rc_codes()
    n = idx.seq_len

    log("building shard-relative occ3 table (memmap)")
    nw3 = (n + 16) // 16 + 2
    rps = -(-nw3 // N_DEV)
    rows_mm = np.lib.format.open_memmap(
        f"{SCRATCH}/occ3_rows.npy", mode="w+", dtype=np.int32,
        shape=(N_DEV * rps, 72))
    t0 = time.time()
    tab = build_occ3_64(idx.sa_full, text, words_per_shard=rps,
                        rows_out=rows_mm[:nw3])
    out["occ3_build_s"] = round(time.time() - t0, 1)
    out["occ3_rows_gb"] = round(rows_mm.nbytes / 2**30, 2)
    # per-symbol counts stay ~n/64 on uniform text; the int64 need is in
    # the interval state / SA / c3_first (recorded + asserted below)
    out["max_abs_occ3_count"] = int(tab.base3[-1].max())
    out["max_c3_first"] = int(tab.c3_first.max())
    rows_mm.flush()

    log("staging sharded device arrays")
    mesh = make_mesh(N_DEV)
    devs = list(mesh.devices.reshape(-1))
    occ_shards = []
    for s, d in enumerate(devs):
        occ_shards.append(jax.device_put(
            np.asarray(rows_mm[s * rps:(s + 1) * rps])[None], d))
        gc.collect()
    with jax.enable_x64(True):
        occ_g = jax.make_array_from_single_device_arrays(
            (N_DEV, rps, 72),
            NamedSharding(mesh, P("dp", None, None)), occ_shards)
        del occ_shards
        sps = -(-(n + 1) // N_DEV)
        sa_shards = []
        for s, d in enumerate(devs):
            sl = idx.sa_full[s * sps:min((s + 1) * sps, n + 1)]
            if sl.size < sps:
                sl = np.concatenate([sl, np.zeros(sps - sl.size, np.int64)])
            sa_shards.append(jax.device_put(np.ascontiguousarray(sl)[None], d))
            gc.collect()
        sa_g = jax.make_array_from_single_device_arrays(
            (N_DEV, sps), NamedSharding(mesh, P("dp", None)), sa_shards)
        del sa_shards
        base3 = np.zeros((N_DEV, 64), dtype=np.int64)
        base3[:tab.base3.shape[0]] = tab.base3
        b3 = jax.device_put(jnp.asarray(base3),
                            NamedSharding(mesh, P(None, None)))
        c3f = jax.device_put(jnp.asarray(tab.c3_first),
                             NamedSharding(mesh, P(None)))
        L2d = jax.device_put(jnp.asarray(np.asarray(idx.L2, np.int64)),
                             NamedSharding(mesh, P(None)))

        log("sampling reads")
        BG = B * N_DEV
        mat = np.zeros((BG, MAXLEN), dtype=np.uint8)
        rlens = np.full(BG, RLEN, dtype=np.int32)
        rpos_true = []
        for b in range(BG):
            p = int(rng.integers(0, n - RLEN))
            r = text[p:p + RLEN].copy()
            if b % 3 == 0:       # mismatches -> multiple seeds per read
                j = int(rng.integers(10, RLEN - 10))
                r[j] = (r[j] + 1 + rng.integers(0, 3)) % 4
            mat[b, :RLEN] = r
            rpos_true.append(p)
        packed = np.zeros((BG, MAXLEN // 4), dtype=np.uint8)
        for j in range(4):
            packed |= (mat[:, j::4] & 3) << (2 * j)
        pk = jax.device_put(jnp.asarray(packed),
                            NamedSharding(mesh, P("dp", None)))
        rl = jax.device_put(jnp.asarray(rlens),
                            NamedSharding(mesh, P("dp")))

        statics = dict(primary=int(idx.primary), row_p1=tab.row_p1,
                       row_p2=tab.row_p2, t0=tab.t0, t1=tab.t1,
                       tail1=tab.tail1, tail2a=tab.tail2a,
                       tail2b=tab.tail2b)
        log("compiling + running x64 sharded kernel")
        t0 = time.time()
        fn = build_big_seed_hits_kernel(mesh, N_DEV, MAXLEN, B, statics)
        got = [np.asarray(x) for x in
               jax.device_get(fn(occ_g, b3, c3f, L2d, sa_g, pk, rl))]
        out["kernel_compile_run_s"] = round(time.time() - t0, 1)

    (n_seeds, s_rpos, s_len, s_x0, s_freq, overflow,
     hit_read, hit_rpos, hit_len, hit_loc, hit_valid, buf_ovf) = got
    assert s_x0.dtype == np.int64 and hit_loc.dtype == np.int64
    out["total_seeds"] = int(n_seeds.sum())
    out["max_x0"] = int(s_x0.max())
    out["x0_beyond_int32"] = bool(out["max_x0"] > 2**31)

    log("host-oracle comparison")
    # greedy-MEM oracle (mirrors pipeline/seeding.bwt_search +
    # BWT_Search's advance rule, ref: src/bwt_search.cpp:121-164),
    # exposing x0/freq for exact comparison
    def oracle_seeds(seq, rlen):
        seeds = []
        pos0 = 0
        stop = rlen - MIN_SEED_LEN
        while pos0 < stop:
            p = int(seq[pos0])
            x0 = int(idx.L2[p]) + 1
            x1 = int(idx.L2[3 - p]) + 1
            x2 = int(idx.L2[p + 1] - idx.L2[p])
            pos = pos0 + 1
            while pos < rlen:
                c = int(seq[pos])
                tk = idx.occ4(x1 - 1)
                tl = idx.occ4(x1 - 1 + x2)
                ok_x1 = [int(idx.L2[i]) + 1 + int(tk[i]) for i in range(4)]
                ok_x2 = [int(tl[i] - tk[i]) for i in range(4)]
                ok_x0 = [0, 0, 0, 0]
                ok_x0[3] = x0 + (1 if (x1 <= idx.primary
                                       and x1 + x2 - 1 >= idx.primary)
                                 else 0)
                ok_x0[2] = ok_x0[3] + ok_x2[3]
                ok_x0[1] = ok_x0[2] + ok_x2[2]
                ok_x0[0] = ok_x0[1] + ok_x2[1]
                i = 3 - c
                if ok_x2[i] == 0:
                    break
                x0, x1, x2 = ok_x0[i], ok_x1[i], ok_x2[i]
                pos += 1
            slen = pos - pos0
            if slen >= MIN_SEED_LEN and x2 <= OCC_THR:
                seeds.append((pos0, slen, x0, x2))
            pos0 = pos0 + slen + 1
        return seeds

    max_seeds = MAXLEN // (MIN_SEED_LEN + 1) + 2
    mismatch = 0
    seeds_checked = 0
    for b in range(BG):
        want = oracle_seeds(mat[b], RLEN)
        gotb = [(int(s_rpos[b, s]), int(s_len[b, s]), int(s_x0[b, s]),
                 int(s_freq[b, s])) for s in range(int(n_seeds[b]))]
        if gotb != want:
            mismatch += 1
            if mismatch <= 3:
                log(f"SEED MISMATCH read {b}: got {gotb} want {want}")
        seeds_checked += len(want)
    out["reads_compared"] = BG
    out["seeds_compared"] = seeds_checked
    out["seed_mismatch_reads"] = mismatch

    # hit locations vs host SA
    hits_checked = 0
    hit_bad = 0
    Hd = hit_loc.shape[0] // N_DEV
    seed_lookup = {}
    for b in range(BG):
        for s in range(int(n_seeds[b])):
            seed_lookup[(b, int(s_rpos[b, s]), int(s_len[b, s]))] = (
                int(s_x0[b, s]), int(s_freq[b, s]))
    for i in range(hit_loc.shape[0]):
        if not hit_valid[i]:
            continue
        key = (int(hit_read[i]), int(hit_rpos[i]), int(hit_len[i]))
        x0, fr = seed_lookup[key]
        locs = {int(idx.sa_full[x0 + k]) for k in range(fr)}
        if int(hit_loc[i]) not in locs:
            hit_bad += 1
        hits_checked += 1
    out["hits_compared"] = hits_checked
    out["hit_mismatches"] = hit_bad
    out["rss_peak_gb"] = round(rss_gb(), 2)
    out["total_s"] = round(time.time() - t_all, 1)
    out["bit_exact"] = (mismatch == 0 and hit_bad == 0
                        and seeds_checked > 100 and hits_checked > 100)

    log(json.dumps(out))
    assert out["bit_exact"], "NOT bit-exact"
    if 2 * L > 2**31:
        assert out["x0_beyond_int32"], "no interval crossed 2^31 — weak proof"


if __name__ == "__main__":
    main()
