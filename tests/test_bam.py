"""BAM output: BGZF container integrity + record round-trip vs SAM text."""
import gzip
import os

import pytest

from mapcaller.config import Config
from mapcaller.index.fmindex import build_index
from mapcaller.io.bam import BamWriter, read_bam
from mapcaller.io.fastq import iter_chunks
from mapcaller.io.sam import sam_headers
from mapcaller.pipeline.engine import MappingEngine
from mapcaller.pipeline.read import ReadState

DATA = os.path.join(os.path.dirname(__file__), "data", "subset")


@pytest.fixture(scope="module")
def toy_idx(toy_fasta):
    return build_index(toy_fasta)


def test_bam_roundtrip_matches_sam(toy_idx, tmp_path):
    cfg = Config(bam_file=str(tmp_path / "out.bam"), vcf_output=False)
    engine = MappingEngine(toy_idx, cfg)
    headers = sam_headers(engine.genome, "0.9.9.41")
    sam_lines = []
    writer = BamWriter(cfg.bam_file, engine.genome, headers)
    for chunk in iter_chunks(os.path.join(DATA, "sub_r1.fq.gz"),
                             os.path.join(DATA, "sub_r2.fq.gz")):
        reads = [ReadState(r.header, r.seq, r.qual) for r in chunk]
        for line in engine.process_chunk(reads, True):
            sam_lines.append(line)
            writer.write_sam_line(line)
    writer.close()
    assert sam_lines, "no SAM records produced"

    # BGZF is valid concatenated gzip (incl. the EOF marker member)
    with gzip.open(cfg.bam_file, "rb") as fh:
        assert fh.read(4) == b"BAM\x01"

    text, names, recs = read_bam(cfg.bam_file)
    assert text.splitlines() == headers
    assert names == list(engine.genome.names)
    assert len(recs) == len(sam_lines)
    for line, rec in zip(sam_lines, recs):
        f = line.split("\t")
        qname, flag, rname, pos, mapq, cigar = (
            f[0], int(f[1]), f[2], int(f[3]), int(f[4]), f[5])
        (b_qname, b_flag, b_ref, b_pos, b_mapq, b_cigar, b_nref, b_npos,
         b_tlen, b_seq, b_qual, b_tags) = rec
        assert b_qname == qname and b_flag == flag
        assert b_pos == pos and b_mapq == mapq and b_cigar == cigar
        if rname == "*":
            assert b_ref == -1
        else:
            assert names[b_ref] == rname
        assert b_seq == f[9]
        assert b_qual == f[10]
        assert b_tlen == int(f[8])
        for tagf in f[11:]:
            tag, typ, val = tagf.split(":", 2)
            if typ == "i":
                assert b_tags[tag] == int(val)


def test_runner_bam_path(toy_idx, toy_fasta, tmp_path):
    """-bam through the CLI runner produces a parseable BAM."""
    from mapcaller.cli import main
    prefix = str(tmp_path / "idx")
    assert main(["mapcaller", "index", toy_fasta, prefix]) == 0
    bam = str(tmp_path / "o.bam")
    rc = main(["mapcaller", "-i", prefix,
               "-f", os.path.join(DATA, "sub_r1.fq.gz"),
               "-f2", os.path.join(DATA, "sub_r2.fq.gz"),
               "-bam", bam, "-no_vcf",
               "-log", str(tmp_path / "job.log")])
    assert rc == 0
    text, names, recs = read_bam(bam)
    assert recs and names
