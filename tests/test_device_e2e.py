"""Device-backend end-to-end: device-kernel seeding feeding the pipeline
must reproduce the golden SAM bit-for-bit (CPU backend here)."""
import gzip
import os

import pytest

from mapcaller.config import Config
from mapcaller.index.fmindex import build_index
from mapcaller.io.fastq import iter_chunks
from mapcaller.io.sam import sam_headers
from mapcaller.pipeline.device_backend import DeviceBackend
from mapcaller.pipeline.engine import MappingEngine
from mapcaller.pipeline.read import ReadState

DATA = os.path.join(os.path.dirname(__file__), "data", "subset")


def read_lines(path):
    with gzip.open(path, "rt") as f:
        return f.read().splitlines()


def test_device_seeding_matches_golden_sam(toy_fasta):
    idx = build_index(toy_fasta)
    cfg = Config(sam_file="x", vcf_output=False, batch_size=256, max_read_len=128)
    backend = DeviceBackend(idx, cfg)
    engine = MappingEngine(idx, cfg, backend=backend)
    sam = sam_headers(engine.genome, "0.9.9.41")
    chunks = list(iter_chunks(os.path.join(DATA, "sub_r1.fq.gz"),
                              os.path.join(DATA, "sub_r2.fq.gz")))
    buffered = [[ReadState(r.header, r.seq, r.qual) for r in ch] for ch in chunks]
    flat = [rd for ch in buffered for rd in ch]
    engine.preseed(flat, True)
    for ch in buffered:
        sam.extend(engine.process_chunk(ch, True))
    golden = read_lines(os.path.join(DATA, "sub_ref.sam.gz"))
    assert sam == golden


@pytest.mark.parametrize("mb,occ3_ok,ev_ok", [
    (4.6, True, True), (60, True, True), (100, True, True),
    (110, True, False), (200, True, False), (500, False, False)])
def test_hbm_budget_predicates(monkeypatch, mb, occ3_ok, ev_ok):
    """Selection is budget-driven, not crash-driven: under an explicit
    16 GB budget the 3-step table needs occ1+occ3+SA+workspace to fit (a
    500 Mb genome doesn't); device evidence additionally needs ~88 B/base
    of planes+finalize (a 200 Mb calling run maps with occ3 and
    accumulates evidence on host)."""
    monkeypatch.setenv("MC_HBM_BYTES", str(16_000_000_000))
    be = DeviceBackend.__new__(DeviceBackend)

    class _I:
        pass

    class _Cfg:
        vcf_output = True

    i = _I()
    i.genome_size = int(mb * 1e6)
    i.seq_len = 2 * i.genome_size
    assert be._occ3_fits(i, _Cfg()) == occ3_ok
    be._fm3_ok = occ3_ok
    assert be._device_evidence_fits(i, _Cfg()) == ev_ok
