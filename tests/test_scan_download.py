"""Scan-download contract: block depths stay device-resident
(LazyBlockDepth) and the cand/run tables come down as bucketed
prefixes — both must agree with the dense host-side derivation
(ref: src/VariantCalling.cpp:106-120 block depth, :550-651 scan)."""
import os

import numpy as np
import pytest

from mapcaller.config import Config
from mapcaller.index.fmindex import build_index
from mapcaller.pipeline.device_backend import DeviceBackend
from mapcaller.pipeline.engine import MappingEngine
from mapcaller.pipeline.stream import run_stream_mapping

DATA = os.path.join(os.path.dirname(__file__), "data", "subset")


@pytest.fixture(scope="module")
def scanned_engine(toy_fasta, tmp_path_factory):
    d = tmp_path_factory.mktemp("scan")
    idx = build_index(toy_fasta)
    cfg = Config(vcf_file=str(d / "out.vcf"), log_file=str(d / "job.log"),
                 batch_size=256, max_read_len=128)
    cfg.read_files1 = [os.path.join(DATA, "sub_r1.fq.gz")]
    cfg.read_files2 = [os.path.join(DATA, "sub_r2.fq.gz")]
    backend = DeviceBackend(idx, cfg)
    engine = MappingEngine(idx, cfg, backend=backend)
    run_stream_mapping(engine, cfg, 0.0)
    engine.finalize()
    assert engine.device_evidence is not None
    scan = engine.device_evidence.scan()
    # materialize the host profile AFTER scan (drops device_evidence)
    engine.materialize_profile()
    return engine, scan


def test_lazy_block_depth_matches_host(scanned_engine):
    from mapcaller.calling.caller import cal_block_read_depth
    engine, (bd, _, _, _, _) = scanned_engine
    host_bd = cal_block_read_depth(engine.profile,
                                   engine.genome.genome_size)
    assert len(bd) == len(host_bd)
    np.testing.assert_array_equal(bd.dense(), np.asarray(host_bd))
    # scalar access path (cache miss then hit) matches dense
    lazy2 = type(bd)(bd._arr, bd.nb)
    probe = [0, len(bd) // 2, len(bd) - 1]
    for b in probe:
        assert lazy2[b] == int(host_bd[b])
    # batched prefetch agrees too
    lazy3 = type(bd)(bd._arr, bd.nb)
    lazy3.prefetch(np.asarray(probe))
    for b in probe:
        assert lazy3[b] == int(host_bd[b])
    with pytest.raises(IndexError):
        lazy2[len(bd)]


def test_prefix_tables_cover_counts(scanned_engine):
    engine, (bd, cand_idx, run_start, run_val, scalars) = scanned_engine
    L = engine.genome.genome_size
    n_cand, n_runs = int(scalars[0]), int(scalars[1])
    assert cand_idx.shape[0] >= min(n_cand, 1)
    assert run_start.shape[0] >= n_runs
    assert run_val.shape[0] >= n_runs
    cand = cand_idx[:n_cand]
    runs = run_start[:n_runs]
    assert np.all((cand >= 0) & (cand < L))
    assert np.all(np.diff(cand) > 0)
    assert runs[0] == 0 and np.all(np.diff(runs) > 0) and runs[-1] < L
    # run states alternate (a run ends only when the state changes)
    vals = run_val[:n_runs]
    assert np.all(vals[1:] != vals[:-1])
    # total coverage scalar matches the host profile reduction
    cov = engine.profile.acgt.sum(axis=0)
    assert int(scalars[3]) == int(cov[cov > 0].astype(np.int64).sum())
