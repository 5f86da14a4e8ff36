"""SVsim-equivalent mutation simulator + observability dumps."""
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from mapcaller.dna import encode, revcomp_codes, decode
from mapcaller.index.packer import iter_fasta
from mapcaller.simulator import mutate_genome


def _write_genome(path, rng, L=120_000):
    s = decode(rng.integers(0, 4, size=L).astype(np.uint8))
    with open(path, "w") as f:
        f.write(">sim1\n")
        for i in range(0, L, 70):
            f.write(s[i:i + 70] + "\n")
    return s


def test_mutate_genome_event_mix(tmp_path, rng):
    fa = str(tmp_path / "g.fa")
    ref = _write_genome(fa, rng, L=2_000_000)
    out_fa = str(tmp_path / "g.mut.fa")
    out_vcf = str(tmp_path / "g.vcf")
    vs = mutate_genome(fa, out_fa, out_vcf, seed=3)
    kinds = {}
    for v in vs:
        k = v.svtype.split(";")[0]
        kinds[k] = kinds.get(k, 0) + 1
    # SVsim rates (per Mb): 3000 SNP, 200 small indel, 50 large indel,
    # ~1 each of INV/TRA/DUP (ref: SVsim.cpp:16-21)
    assert kinds["SUBSTITUTE"] > 4000
    assert kinds["INSERT"] + kinds["DELETE"] > 300
    assert kinds.get("INVERT", 0) >= 1
    assert kinds.get("TRANSLOCATE", 0) >= 1
    assert kinds.get("DUPLICATE", 0) >= 1

    # spot-check structure: inversion region is the revcomp of the ref
    mut = dict(iter_fasta(out_fa))["sim1"]
    inv = next(v for v in vs if v.svtype.startswith("INVERT"))
    end = int(v.svtype.split("END=")[1]) if False else int(
        inv.svtype.split("END=")[1])
    size = end - (inv.pos - 1)
    # locate: mutant position of the inversion = ref pos shifted by all
    # prior indel/dup/tra length changes; instead verify CONTENT exists
    seg = decode(revcomp_codes(encode(ref[inv.pos - 1:end])))
    assert seg in mut
    # truth VCF written
    lines = open(out_vcf).read().splitlines()
    assert lines[0].startswith("##maf") and len(lines) == len(vs) + 1


def test_sim_subcommand(tmp_path, rng):
    fa = str(tmp_path / "g.fa")
    _write_genome(fa, rng)
    from mapcaller.cli import main
    rc = main(["mapcaller", "sim", fa, str(tmp_path / "out"), "5", "100"])
    assert rc == 0
    assert os.path.exists(str(tmp_path / "out.mut.fa"))
    assert os.path.exists(str(tmp_path / "out.vcf"))
    assert os.path.exists(str(tmp_path / "out_1.fq"))
    assert os.path.exists(str(tmp_path / "out_2.fq"))


def test_observe_dump(toy_fasta, tmp_path):
    from mapcaller.config import Config
    from mapcaller.index.fmindex import build_index
    from mapcaller.io.fastq import iter_chunks
    from mapcaller.pipeline.engine import MappingEngine
    from mapcaller.pipeline.read import ReadState
    from mapcaller.tools import observe

    DATA = os.path.join(os.path.dirname(__file__), "data", "subset")
    idx = build_index(toy_fasta)
    cfg = Config(vcf_file=str(tmp_path / "o.vcf"))
    engine = MappingEngine(idx, cfg)
    for ch in iter_chunks(os.path.join(DATA, "sub_r1.fq.gz"),
                          os.path.join(DATA, "sub_r2.fq.gz")):
        engine.process_chunk([ReadState(r.header, r.seq, r.qual) for r in ch],
                             True)
    engine.finalize()
    buf = io.StringIO()
    observe(engine.genome, engine.profile, engine.ref_chars,
            obs_pos=1000, obr_beg=2000, obr_end=2005, out=buf)
    text = buf.getvalue()
    assert "cov=" in text and "[A=" in text
    assert text.count("\n\n") >= 2  # two region dumps
