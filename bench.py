#!/usr/bin/env python
"""Benchmark: map+call reads/s on one GPU on a synthetic E. coli-scale set.

A seeded 4.6 Mb random genome, a mutant of it and 1,000,000 paired
100 bp reads (made once into the git-ignored `.bench_data/`), mapped and
called through the stream path: one untimed warm-up pass, then the best
of three timed passes on the warm engine.

Prints the device, then ONE JSON line: {"metric", "value", "unit",
"device", "extra"}. Exits non-zero when JAX finds no GPU.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

BENCH_DIR = os.path.join(ROOT, ".bench_data")      # git-ignored
# large enough that the 131k-read compacted stream batches fill and the
# drain tail amortizes (the auto-compaction policy in pipeline/stream.py
# needs >= ~786k reads to engage)
N_PAIRS = 500_000
GENOME_SEED, MUTANT_SEED, READS_SEED = 99, 7, 11
GENOME_LEN = 4_600_000


def ensure_fixtures(data_dir: str = BENCH_DIR, n_pairs: int = N_PAIRS):
    """-> (genome fasta, reads_1, reads_2), made from the seeds above on
    first use."""
    import numpy as np
    from mapcaller.dna import decode
    from mapcaller.simulator import mutate_genome, write_paired_fastq
    os.makedirs(data_dir, exist_ok=True)
    fa = f"{data_dir}/ecoli.fa"
    mut = f"{data_dir}/ecoli_mut.fa"
    r1, r2 = f"{data_dir}/r1_{n_pairs}.fq", f"{data_dir}/r2_{n_pairs}.fq"
    if not os.path.exists(fa):
        rng = np.random.default_rng(GENOME_SEED)
        s = decode(rng.integers(0, 4, size=GENOME_LEN).astype(np.uint8))
        with open(fa, "w") as f:
            f.write(">EcoliSynth\n")
            for i in range(0, GENOME_LEN, 70):
                f.write(s[i:i + 70] + "\n")
    if not os.path.exists(mut):
        mutate_genome(fa, mut, f"{data_dir}/ecoli_truth.vcf",
                      seed=MUTANT_SEED, inv_per_mb=0, tnl_per_mb=0,
                      cnv_per_mb=0)
    if not os.path.exists(r2):
        write_paired_fastq(mut, r1, r2, n_pairs, seed=READS_SEED)
    return fa, r1, r2


def bench_index(data_dir: str = BENCH_DIR, n_pairs: int = N_PAIRS):
    """-> (loaded FMIndex, reads_1, reads_2) of the bench deployment."""
    from mapcaller.index.fmindex import build_index, index_exists, load_index
    fa, r1, r2 = ensure_fixtures(data_dir, n_pairs)
    if not index_exists(f"{data_dir}/mci"):
        build_index(fa, f"{data_dir}/mci")
    return load_index(f"{data_dir}/mci"), r1, r2


def require_gpu() -> dict:
    """Name the device; a benchmark that finds no GPU fails."""
    import jax
    devs = jax.devices()
    dev = {"platform": devs[0].platform, "kind": devs[0].device_kind,
           "count": len(devs)}
    print(f"[device] {dev}", file=sys.stderr)
    if dev["platform"] != "gpu":
        sys.exit(f"no GPU found (JAX platform {dev['platform']!r})")
    return dev


def main():
    from mapcaller import enable_compilation_cache, tune_host_allocator
    dev = require_gpu()
    tune_host_allocator()
    enable_compilation_cache()
    idx, sub1, sub2 = bench_index()

    from mapcaller.config import Config
    from mapcaller.io.fastq import iter_chunks
    from mapcaller.pipeline.read import ReadState
    from mapcaller.runner import make_engine, run_calling

    cfg = Config(vcf_file=f"{BENCH_DIR}/out.vcf", log_file=f"{BENCH_DIR}/job.log",
                 batch_size=8192, max_read_len=128)
    if os.environ.get("MC_FOLD_EVIDENCE"):
        cfg.fold_evidence = os.environ["MC_FOLD_EVIDENCE"] == "1"
    if os.environ.get("MC_STREAM_BATCH"):
        cfg.stream_batch_size = int(os.environ["MC_STREAM_BATCH"])
    if os.environ.get("MC_COMPACT_FACTOR"):
        cfg.compact_factor = int(os.environ["MC_COMPACT_FACTOR"])
    if os.environ.get("MC_STREAM_GROUP"):
        cfg.stream_group = int(os.environ["MC_STREAM_GROUP"])
    if os.environ.get("MC_STREAM_DEPTH"):
        cfg.stream_pipeline_depth = int(os.environ["MC_STREAM_DEPTH"])
    engine = make_engine(idx, cfg)
    assert engine.backend is not None and engine.native is not None

    # warm up / compile on a tiny prefix (excluded from timing)
    warm = []
    for ch in iter_chunks(sub1, sub2):
        warm = [ReadState(r.header, r.seq, r.qual) for r in ch]
        break
    engine.preseed(warm, True)

    from mapcaller.pipeline.stream import run_stream_mapping
    cfg.read_files1 = [sub1]
    cfg.read_files2 = [sub2]

    # warm-up pass (untimed): faults the allocator heap + JIT caches so
    # the timed pass measures steady-state throughput, not first-touch
    # page faults
    run_stream_mapping(engine, cfg, time.time())
    engine.finalize()
    run_calling(engine, cfg, "bench-warmup")

    # timed: best of 3 steady-state passes (host page-fault noise can
    # double a single pass).
    # Passes reuse the warm engine via reset_run (in-place plane memset,
    # byte-identical to a fresh engine — tests/test_engine_reuse.py):
    # re-allocating genome-sized planes per pass re-faults them inside
    # the timed window, which measures the VM's page-fault pathology,
    # not the pipeline.
    map_time = call_time = float("inf")
    passes = []
    for _ in range(3):
        engine.reset_run()
        t0 = time.time()
        run_stream_mapping(engine, cfg, t0)
        engine.finalize()
        mt = time.time() - t0
        t1 = time.time()
        run_calling(engine, cfg, "bench")
        ct = time.time() - t1
        passes.append(round(mt + ct, 2))
        if mt + ct < map_time + call_time:
            map_time, call_time = mt, ct

    total = engine.stats.total_reads
    rps = total / (map_time + call_time)
    result = {
        "metric": "reads/s (map+call, synthetic E. coli 4.6Mb, "
                  "1M-read steady state, one device)",
        "value": rps,
        "unit": "reads/s",
        "device": dev,
        "extra": {
            "n_reads": total,
            "compact_factor": cfg.compact_factor,
            "stream_batch": cfg.stream_batch_size,
            "stream_group": cfg.stream_group,
            "map_s": round(map_time, 2),
            "call_s": round(call_time, 2),
            "mapped_pct": round(100.0 * engine.stats.total_mapped / max(total, 1), 2),
            "pass_times_s": passes,
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
