"""PFM checkpoint (SURVEY section 5 optional item): -pfm saves the
post-mapping evidence profile; -pfm_resume re-runs calling from it
without re-mapping, and the VCF must be byte-identical — including
re-calling under DIFFERENT calling flags (the point of the feature).
Ref contrast: the reference persists only the index and rebuilds its
PFM every run (src/bwt_index.cpp:126-148, main.cpp:372)."""
import os

from mapcaller.cli import main

DATA = os.path.join(os.path.dirname(__file__), "data", "subset")


def _vcf_body(path):
    return [l for l in open(path).read().splitlines()
            if not l.startswith("##")]


def test_pfm_checkpoint_resume_byte_identical(tmp_path, toy_fasta):
    idx = str(tmp_path / "idx")
    assert main(["mapcaller", "index", toy_fasta, idx]) == 0
    pfm = str(tmp_path / "run.pfm")
    args = ["mapcaller", "-i", idx,
            "-f", os.path.join(DATA, "sub_r1.fq.gz"),
            "-f2", os.path.join(DATA, "sub_r2.fq.gz")]
    assert main(args + ["-vcf", str(tmp_path / "direct.vcf"),
                        "-log", str(tmp_path / "a.log"), "-pfm", pfm]) == 0
    assert os.path.exists(pfm) and os.path.exists(pfm + ".json")
    assert main(["mapcaller", "-i", idx, "-pfm_resume", pfm,
                 "-vcf", str(tmp_path / "resumed.vcf"),
                 "-log", str(tmp_path / "b.log")]) == 0
    assert _vcf_body(str(tmp_path / "resumed.vcf")) == \
        _vcf_body(str(tmp_path / "direct.vcf"))

    # re-call under different thresholds from the same checkpoint
    assert main(args + ["-vcf", str(tmp_path / "direct_ad3.vcf"),
                        "-log", str(tmp_path / "c.log"), "-ad", "3"]) == 0
    assert main(["mapcaller", "-i", idx, "-pfm_resume", pfm, "-ad", "3",
                 "-vcf", str(tmp_path / "resumed_ad3.vcf"),
                 "-log", str(tmp_path / "d.log")]) == 0
    assert _vcf_body(str(tmp_path / "resumed_ad3.vcf")) == \
        _vcf_body(str(tmp_path / "direct_ad3.vcf"))
    assert len(_vcf_body(str(tmp_path / "resumed_ad3.vcf"))) > 3
