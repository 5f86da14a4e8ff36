"""Multi-host simulation: N engines map disjoint read shards, evidence
reduces by sum/merge, one calling pass — VCF equals the single-host run."""
import gzip
import os
import time

import pytest

from mapcaller.config import Config
from mapcaller.index.fmindex import build_index
from mapcaller.parallel.distributed import merge_engines
from mapcaller.pipeline.device_backend import DeviceBackend
from mapcaller.pipeline.engine import MappingEngine
from mapcaller.pipeline.stream import run_stream_mapping

DATA = os.path.join(os.path.dirname(__file__), "data", "subset")


@pytest.fixture(scope="module")
def toy_idx(toy_fasta):
    return build_index(toy_fasta)


def _split_fastq(path, out_paths):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        recs = f.read().splitlines()
    recs = [recs[i:i + 4] for i in range(0, len(recs), 4)]
    n = len(recs)
    k = len(out_paths)
    per = (n + k - 1) // k
    for i, op in enumerate(out_paths):
        with open(op, "w") as f:
            for r in recs[i * per:(i + 1) * per]:
                f.write("\n".join(r) + "\n")


@pytest.mark.parametrize("n_hosts", [2, 4])
def test_sharded_mapping_merged_vcf_matches_single(toy_idx, tmp_path, n_hosts):
    r1_shards = [str(tmp_path / f"r1_{i}.fq") for i in range(n_hosts)]
    r2_shards = [str(tmp_path / f"r2_{i}.fq") for i in range(n_hosts)]
    _split_fastq(os.path.join(DATA, "sub_r1.fq.gz"), r1_shards)
    _split_fastq(os.path.join(DATA, "sub_r2.fq.gz"), r2_shards)

    def run_single():
        cfg = Config(vcf_file=str(tmp_path / "single.vcf"),
                     batch_size=256, stream_batch_size=256, max_read_len=128,
                     log_file=str(tmp_path / "s.log"))
        backend = DeviceBackend(toy_idx, cfg)
        engine = MappingEngine(toy_idx, cfg, backend=backend)
        cfg.read_files1 = [os.path.join(DATA, "sub_r1.fq.gz")]
        cfg.read_files2 = [os.path.join(DATA, "sub_r2.fq.gz")]
        run_stream_mapping(engine, cfg, time.time())
        engine.finalize()
        from mapcaller.runner import run_calling
        run_calling(engine, cfg, "x")
        return cfg.vcf_file

    def run_sharded():
        engines = []
        cfg = None
        for i in range(n_hosts):
            cfg = Config(vcf_file=str(tmp_path / "merged.vcf"),
                         batch_size=256, stream_batch_size=256,
                         max_read_len=128, log_file=str(tmp_path / "m.log"))
            backend = DeviceBackend(toy_idx, cfg)
            engine = MappingEngine(toy_idx, cfg, backend=backend)
            cfg.read_files1 = [r1_shards[i]]
            cfg.read_files2 = [r2_shards[i]]
            run_stream_mapping(engine, cfg, time.time())
            engines.append(engine)
        root = merge_engines(engines)
        from mapcaller.runner import run_calling
        run_calling(root, cfg, "x")
        return cfg.vcf_file

    single = run_single()
    merged = run_sharded()

    def body(p):
        return [l for l in open(p).read().splitlines()
                if not l.startswith("##")]

    assert body(merged) == body(single)


MODES = os.path.join(os.path.dirname(__file__), "data", "modes")


def _run_engine(idx, cfg, f1, f2):
    backend = DeviceBackend(idx, cfg)
    engine = MappingEngine(idx, cfg, backend=backend)
    cfg.read_files1 = [f1]
    cfg.read_files2 = [f2] if f2 else []
    run_stream_mapping(engine, cfg, time.time())
    return engine


def test_sharded_sv_dataset_matches_single(toy_idx, tmp_path):
    """The SV dataset (inversions + translocations + deletions) through
    the 2-shard merge: discordant-site lists (inv_sites/tnl_sites) and
    breakpoint events must merge so the <INV>/<TNL> records are
    bit-identical to the single run (ref: VariantCalling.cpp:219-285 fed
    by the merged INVSiteVec/TNLSiteVec, ReadMapping.cpp:627-643)."""
    n_hosts = 2
    r1s = [str(tmp_path / f"sv1_{i}.fq") for i in range(n_hosts)]
    r2s = [str(tmp_path / f"sv2_{i}.fq") for i in range(n_hosts)]
    _split_fastq(os.path.join(MODES, "sv_r1.fq.gz"), r1s)
    _split_fastq(os.path.join(MODES, "sv_r2.fq.gz"), r2s)

    cfg = Config(vcf_file=str(tmp_path / "sv_single.vcf"),
                 batch_size=256, stream_batch_size=256, max_read_len=128,
                 log_file=str(tmp_path / "s.log"))
    engine = _run_engine(toy_idx, cfg, os.path.join(MODES, "sv_r1.fq.gz"),
                         os.path.join(MODES, "sv_r2.fq.gz"))
    engine.finalize()
    from mapcaller.runner import run_calling
    run_calling(engine, cfg, "x")
    single = cfg.vcf_file

    engines = []
    for i in range(n_hosts):
        cfg_i = Config(vcf_file=str(tmp_path / "sv_merged.vcf"),
                       batch_size=256, stream_batch_size=256,
                       max_read_len=128, log_file=str(tmp_path / "m.log"))
        engines.append(_run_engine(toy_idx, cfg_i, r1s[i], r2s[i]))
    root = merge_engines(engines)
    run_calling(root, cfg_i, "x")

    def body(p):
        return [l for l in open(p).read().splitlines()
                if not l.startswith("##")]

    got = body(cfg_i.vcf_file)
    assert got == body(single)
    assert sum("<INV>" in l for l in got) >= 2, "INV records expected"
    assert sum("<TNL>" in l for l in got) >= 2, "TNL records expected"


def test_sharded_insertion_reads_match_single(toy_idx, tmp_path):
    """Insertion pileups through the 2-shard merge: insert_map events
    must merge to bit-identical TYPE=ins records."""
    import numpy as np
    from mapcaller.dna import decode
    rng = np.random.default_rng(5)
    g = toy_idx.ref.codes
    RL = 100
    recs = []
    for p in range(2000, 12000, 40):            # background depth
        recs.append((g[p:p + RL], g[p + 280:p + 280 + RL]))
    ins_seq = np.asarray([0, 2, 1, 3], dtype=np.uint8)   # 4bp (VCF
    # writer mirrors the reference skip of ins >5bp, io/vcf.py:140)
    site = 7000
    for k in range(12):                          # insertion pileup
        p = site - 30 - 4 * k
        r1 = np.concatenate([g[p:site], ins_seq, g[site:]])[:RL]
        recs.append((r1, g[p + 280:p + 280 + RL]))
    r1p, r2p = str(tmp_path / "i1.fq"), str(tmp_path / "i2.fq")
    comp = (3 - g)
    with open(r1p, "w") as f1, open(r2p, "w") as f2:
        for i, (a, b) in enumerate(recs):
            f1.write(f"@i{i}/1\n{decode(a)}\n+\n{'I' * len(a)}\n")
            b_rc = decode((3 - b)[::-1])
            f2.write(f"@i{i}/2\n{b_rc}\n+\n{'I' * len(b)}\n")

    n_hosts = 2
    r1s = [str(tmp_path / f"ii1_{i}.fq") for i in range(n_hosts)]
    r2s = [str(tmp_path / f"ii2_{i}.fq") for i in range(n_hosts)]
    _split_fastq(r1p, r1s)
    _split_fastq(r2p, r2s)

    cfg = Config(vcf_file=str(tmp_path / "ins_single.vcf"),
                 batch_size=256, stream_batch_size=256, max_read_len=128,
                 log_file=str(tmp_path / "s.log"))
    engine = _run_engine(toy_idx, cfg, r1p, r2p)
    engine.finalize()
    from mapcaller.runner import run_calling
    run_calling(engine, cfg, "x")
    single = cfg.vcf_file

    engines = []
    for i in range(n_hosts):
        cfg_i = Config(vcf_file=str(tmp_path / "ins_merged.vcf"),
                       batch_size=256, stream_batch_size=256,
                       max_read_len=128, log_file=str(tmp_path / "m.log"))
        engines.append(_run_engine(toy_idx, cfg_i, r1s[i], r2s[i]))
    root = merge_engines(engines)
    run_calling(root, cfg_i, "x")

    def body(p):
        return [l for l in open(p).read().splitlines()
                if not l.startswith("##")]

    got = body(cfg_i.vcf_file)
    assert got == body(single)
    assert any("TYPE=ins" in l for l in got), "ins record expected"
