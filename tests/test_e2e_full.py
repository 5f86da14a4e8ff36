"""Full-toy end-to-end parity (slow; run with -m slow or RUN_SLOW=1)."""
import gzip
import os

import pytest

from mapcaller.config import Config
from mapcaller.index.fmindex import build_index
from mapcaller.io.fastq import iter_chunks
from mapcaller.io.sam import sam_headers
from mapcaller.pipeline.engine import MappingEngine
from mapcaller.pipeline.read import ReadState
from mapcaller.runner import run_calling

DATA = os.path.join(os.path.dirname(__file__), "data")

slow = pytest.mark.skipif(not os.environ.get("RUN_SLOW"),
                          reason="set RUN_SLOW=1 for full-toy parity run (~3 min)")


def read_lines(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        return f.read().splitlines()


@slow
def test_full_toy_pe_nw_parity(toy_fasta, tmp_path):
    idx = build_index(toy_fasta)
    cfg = Config(sam_file="x", vcf_file=str(tmp_path / "out.vcf"))
    engine = MappingEngine(idx, cfg)
    sam = sam_headers(engine.genome, "0.9.9.41")
    for chunk in iter_chunks(os.path.join(DATA, "r1.fq.gz"),
                             os.path.join(DATA, "r2.fq.gz")):
        reads = [ReadState(r.header, r.seq, r.qual) for r in chunk]
        sam.extend(engine.process_chunk(reads, True))
    engine.finalize()
    assert sam == read_lines(os.path.join(DATA, "golden_pe_nw.sam.gz"))
    run_calling(engine, cfg, "test")
    got = [l for l in read_lines(cfg.vcf_file)
           if not l.startswith("##command_line") and not l.startswith("##reference")]
    want = [l for l in read_lines(os.path.join(DATA, "golden_pe.vcf"))
            if not l.startswith("##command_line") and not l.startswith("##reference")]
    assert got == want
