"""Engine reuse via MappingEngine.reset_run: a second run on the SAME
engine (planes memset in place, C++ per-run accumulators cleared) must
reproduce the fresh-engine golden SAM/VCF bit-for-bit. This is the
long-running/server path — re-allocating genome-sized planes per run
costs tens of seconds of page-faulting on large genomes."""
import gzip
import os
import time

import pytest

from mapcaller.config import Config
from mapcaller.index.fmindex import build_index
from mapcaller.io.sam import sam_headers
from mapcaller.pipeline.device_backend import DeviceBackend
from mapcaller.pipeline.engine import MappingEngine
from mapcaller.pipeline.stream import run_stream_mapping

DATA = os.path.join(os.path.dirname(__file__), "data", "subset")


def read_lines(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        return f.read().splitlines()


@pytest.fixture(scope="module")
def toy_idx(toy_fasta):
    return build_index(toy_fasta)


def _one_run(engine, cfg, tag, tmp_path):
    parts = []
    run_stream_mapping(engine, cfg, time.time(), parts.append)
    engine.finalize()
    sam = sam_headers(engine.genome, "0.9.9.41")
    sam.extend("".join(parts).splitlines())
    from mapcaller.runner import run_calling
    cfg.vcf_file = str(tmp_path / f"out_{tag}.vcf")
    run_calling(engine, cfg, "test")
    vcf = [l for l in read_lines(cfg.vcf_file)
           if not l.startswith("##command_line")
           and not l.startswith("##reference")]
    return sam, vcf


def test_reset_run_reproduces_fresh_engine(toy_idx, tmp_path):
    cfg = Config(sam_file="x", vcf_file=str(tmp_path / "out.vcf"),
                 batch_size=256, stream_batch_size=256, max_read_len=128)
    cfg.read_files1 = [os.path.join(DATA, "sub_r1.fq.gz")]
    cfg.read_files2 = [os.path.join(DATA, "sub_r2.fq.gz")]
    backend = DeviceBackend(toy_idx, cfg)
    engine = MappingEngine(toy_idx, cfg, backend=backend, use_native=True)
    assert engine.native is not None, "native runtime required"

    sam1, vcf1 = _one_run(engine, cfg, "a", tmp_path)
    golden = read_lines(os.path.join(DATA, "sub_ref.sam.gz"))
    assert sam1 == golden

    engine.reset_run()
    assert engine.stats.total_reads == 0
    sam2, vcf2 = _one_run(engine, cfg, "b", tmp_path)
    assert sam2 == sam1
    assert vcf2 == vcf1
