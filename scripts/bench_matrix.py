#!/usr/bin/env python
"""Benchmark matrix beyond bench.py's headline row: SE/ksw2 mode, a
3%-divergent read set (where gapped extension fires) with the scalar C++
aligners and with the device DP kernels, and index-build time.

    python scripts/bench_matrix.py [row ...]      # default: every row

Each row runs in its own process (a clean device and host heap; the
parent never touches the device), with one
untimed warm-up pass and one timed pass on the warm engine. Names the
device and fails without a GPU; prints the rows as one JSON object.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402

N_PE_PAIRS = 100_000
N_DIV = 200_000


def divergent_reads(idx, path: str, n: int = N_DIV) -> str:
    """Single-end 100 bp reads at 3% substitutions, 10% with a 2-5 bp
    deletion: most of them reach the gapped-extension DP."""
    import numpy as np
    from mapcaller.dna import decode
    if os.path.exists(path):
        return path
    rng = np.random.default_rng(3)
    g = idx.ref.codes
    L = idx.genome_size
    with open(path, "w") as f:
        for k in range(n):
            p = int(rng.integers(0, L - 110))
            c = g[p:p + 100].copy()
            for _ in range(rng.binomial(100, 0.03)):
                j = int(rng.integers(0, 100))
                c[j] = (c[j] + 1 + rng.integers(0, 3)) % 4
            if k % 10 == 0:
                d = int(rng.integers(2, 6))
                c = np.concatenate([g[p:p + 50],
                                    g[p + 50 + d:p + 110]])[:100]
            f.write(f"@v{k}\n{decode(c)}\n+\n{'I' * 100}\n")
    return path


def _head(src: str, n_reads: int, dst: str) -> str:
    if not os.path.exists(dst):
        with open(src) as f, open(dst, "w") as g:
            for i, line in enumerate(f):
                if i >= 4 * n_reads:
                    break
                g.write(line)
    return dst


def run_map_call(idx, cfg_kwargs, files, n_expect):
    from mapcaller.config import Config
    from mapcaller.pipeline.stream import run_stream_mapping
    from mapcaller.runner import make_engine, run_calling
    d = bench.BENCH_DIR
    cfg = Config(vcf_file=f"{d}/mx.vcf", log_file=f"{d}/mx.log",
                 batch_size=8192, max_read_len=128, **cfg_kwargs)
    engine = make_engine(idx, cfg)
    cfg.read_files1 = [files[0]]
    cfg.read_files2 = [files[1]] if files[1] else []
    dt = 0.0
    for _ in range(2):          # pass 0 = warm-up/compile
        engine.reset_run()
        t0 = time.time()
        run_stream_mapping(engine, cfg, t0)
        engine.finalize()
        run_calling(engine, cfg, "bench-matrix")
        dt = time.time() - t0
    n = engine.stats.total_reads
    if n != n_expect:
        raise SystemExit(f"processed {n} reads, expected {n_expect}")
    return n / dt


ROWS = {
    "pe_nw": ({}, "pe", 2 * N_PE_PAIRS),
    "se_ksw2": ({"use_nw": False}, "se", N_PE_PAIRS),
    "divergent3pct_nw_scalar": ({}, "div", N_DIV),
    "divergent3pct_nw_device": ({"device_extension": True}, "div", N_DIV),
    "divergent3pct_ksw2_scalar": ({"use_nw": False}, "div", N_DIV),
    "divergent3pct_ksw2_device": ({"use_nw": False,
                                   "device_extension": True}, "div", N_DIV),
}


def run_row(name: str):
    idx, r1, r2 = bench.bench_index()
    if name == "index_build_s_4.6Mb":
        from mapcaller.index.fmindex import build_index
        t0 = time.time()
        build_index(f"{bench.BENCH_DIR}/ecoli.fa",
                    f"{bench.BENCH_DIR}/mci_rebuild")
        return time.time() - t0
    kwargs, reads, n = ROWS[name]
    d = bench.BENCH_DIR
    files = {"pe": (_head(r1, N_PE_PAIRS, f"{d}/mx_r1.fq"),
                    _head(r2, N_PE_PAIRS, f"{d}/mx_r2.fq")),
             "se": (_head(r1, N_PE_PAIRS, f"{d}/mx_r1.fq"), None),
             "div": (divergent_reads(idx, f"{d}/div{N_DIV}.fq"), None)}
    return run_map_call(idx, kwargs, files[reads], n)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--row":
        from mapcaller import enable_compilation_cache, tune_host_allocator
        dev = bench.require_gpu()
        tune_host_allocator()
        enable_compilation_cache()
        print(json.dumps({"device": dev, sys.argv[2]: run_row(sys.argv[2])}))
        return
    # this process stays off JAX: only one process at a time holds the card
    names = sys.argv[1:] or ["index_build_s_4.6Mb", *ROWS]
    rows = {}
    for name in names:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--row", name],
            capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            sys.stderr.write(out.stderr[-3000:])
            raise SystemExit(f"row {name} failed")
        rows.update(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps({name: rows[name]}), file=sys.stderr, flush=True)
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
