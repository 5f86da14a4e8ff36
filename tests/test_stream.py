"""Stream fast path (native parse + device seeding + batch processing)
must reproduce the golden SAM/VCF bit-for-bit."""
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


def _run(toy_idx, cfg, f1, f2=None):
    backend = DeviceBackend(toy_idx, cfg)
    engine = MappingEngine(toy_idx, cfg, backend=backend, use_native=True)
    assert engine.native is not None, "native runtime required"
    cfg.read_files1 = [f1]
    cfg.read_files2 = [f2] if f2 else []
    parts = []
    run_stream_mapping(engine, cfg, time.time(), parts.append)
    engine.finalize()
    sam = sam_headers(engine.genome, "0.9.9.41")
    sam.extend("".join(parts).splitlines())
    return engine, sam


def test_stream_pe_matches_golden(toy_idx, tmp_path):
    cfg = Config(sam_file="x", vcf_file=str(tmp_path / "out.vcf"),
                 batch_size=256, stream_batch_size=256, max_read_len=128)
    engine, sam = _run(toy_idx, cfg,
                       os.path.join(DATA, "sub_r1.fq.gz"),
                       os.path.join(DATA, "sub_r2.fq.gz"))
    golden = read_lines(os.path.join(DATA, "sub_ref.sam.gz"))
    assert sam == golden

    from mapcaller.runner import run_calling
    run_calling(engine, cfg, "test")
    got = [l for l in read_lines(cfg.vcf_file)
           if not l.startswith("##command_line") and not l.startswith("##reference")]
    want = [l for l in read_lines(os.path.join(DATA, "sub_ref.vcf"))
            if not l.startswith("##command_line") and not l.startswith("##reference")]
    assert got == want


def test_stream_se_matches_golden(toy_idx):
    cfg = Config(sam_file="x", vcf_output=False,
                 batch_size=256, stream_batch_size=256, max_read_len=128)
    engine, sam = _run(toy_idx, cfg, os.path.join(DATA, "sub_r1.fq.gz"))
    golden = read_lines(os.path.join(DATA, "sub_ref_se.sam.gz"))

    # the reference's single-end reversed-qual heap bug (SamReport.cpp:318)
    def norm(lines):
        out = []
        for ln in lines:
            if ln.startswith("@"):
                out.append(ln)
                continue
            f = ln.split("\t")
            if len(f) > 10 and int(f[1]) & 0x10 and f[10] not in ("*", ""):
                f[10] = "?" + f[10][1:]
            out.append("\t".join(f))
        return out

    assert norm(sam) == norm(golden)


def test_stream_multiple_batches(toy_idx):
    """Batch boundary handling: tiny batches force many slot swaps."""
    cfg = Config(sam_file="x", vcf_output=False,
                 batch_size=64, stream_batch_size=64, max_read_len=128)
    engine, sam = _run(toy_idx, cfg,
                       os.path.join(DATA, "sub_r1.fq.gz"),
                       os.path.join(DATA, "sub_r2.fq.gz"))
    golden = read_lines(os.path.join(DATA, "sub_ref.sam.gz"))
    assert sam == golden


def test_stream_pe_compact_matches_golden(toy_idx, tmp_path):
    """Production path with seed-scan lane compaction (compact_factor=2,
    lanes = batch/2) must stay byte-identical to the golden SAM/VCF."""
    cfg = Config(sam_file="x", vcf_file=str(tmp_path / "outc.vcf"),
                 batch_size=256, stream_batch_size=256, max_read_len=128,
                 compact_factor=2)
    engine, sam = _run(toy_idx, cfg,
                       os.path.join(DATA, "sub_r1.fq.gz"),
                       os.path.join(DATA, "sub_r2.fq.gz"))
    golden = read_lines(os.path.join(DATA, "sub_ref.sam.gz"))
    assert sam == golden

    from mapcaller.runner import run_calling
    run_calling(engine, cfg, "test")
    got = [l for l in read_lines(cfg.vcf_file)
           if not l.startswith("##command_line") and not l.startswith("##reference")]
    want = [l for l in read_lines(os.path.join(DATA, "sub_ref.vcf"))
            if not l.startswith("##command_line") and not l.startswith("##reference")]
    assert got == want


def test_stream_host_evidence_fallback_matches_golden(toy_idx, tmp_path):
    """The host-evidence fallback (evidence planes too big for HBM —
    DeviceBackend._device_evidence_fits false, e.g. >~100 Mb genomes on
    a 16 GB chip) must stay byte-identical: seeding/chaining on device,
    evidence in the C++ diff arrays."""
    cfg = Config(sam_file="x", vcf_file=str(tmp_path / "out.vcf"),
                 batch_size=256, stream_batch_size=256, max_read_len=128,
                 device_evidence=False)
    engine, sam = _run(toy_idx, cfg,
                       os.path.join(DATA, "sub_r1.fq.gz"),
                       os.path.join(DATA, "sub_r2.fq.gz"))
    assert engine.device_evidence is None
    golden = read_lines(os.path.join(DATA, "sub_ref.sam.gz"))
    assert sam == golden

    from mapcaller.runner import run_calling
    run_calling(engine, cfg, "test")
    got = [l for l in read_lines(cfg.vcf_file)
           if not l.startswith("##command_line")
           and not l.startswith("##reference")]
    want = [l for l in read_lines(os.path.join(DATA, "sub_ref.vcf"))
            if not l.startswith("##command_line")
            and not l.startswith("##reference")]
    assert got == want
