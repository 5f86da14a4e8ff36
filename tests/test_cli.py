"""CLI surface: -r on-the-fly index, -lib file-of-filenames, update stub,
usage/version paths (ref: src/main.cpp:136-207,344-349)."""
import gzip
import os

import pytest

from mapcaller.cli import main, parse_args

DATA = os.path.join(os.path.dirname(__file__), "data", "subset")


def test_on_the_fly_index(toy_fasta, tmp_path, monkeypatch):
    """-r builds a throwaway index and removes it on exit
    (ref: main.cpp:344-349, 385-389)."""
    monkeypatch.chdir(tmp_path)
    rc = main(["mapcaller", "-r", toy_fasta,
               "-f", os.path.join(DATA, "sub_r1.fq.gz"),
               "-f2", os.path.join(DATA, "sub_r2.fq.gz"),
               "-vcf", str(tmp_path / "out.vcf"),
               "-log", str(tmp_path / "j.log")])
    assert rc == 0
    got = [l for l in open(tmp_path / "out.vcf").read().splitlines()
           if not l.startswith("##")]
    want = [l for l in gzip.open(os.path.join(
        os.path.dirname(__file__), "data", "modes", "filter.vcf.gz"),
        "rt").read().splitlines() if not l.startswith("##")]
    # same records as the unfiltered default run (filter only changes FILTER col)
    assert len(got) == len(want)
    # temp index removed
    leftovers = [f for f in os.listdir(tmp_path)
                 if f.endswith((".mci.npz", ".mci.bin", ".occ3.bin"))]
    assert leftovers == []


def test_lib_input(toy_fasta, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    lib = tmp_path / "files.lib"
    lib.write_text(f"{os.path.join(DATA, 'sub_r1.fq.gz')} "
                   f"{os.path.join(DATA, 'sub_r2.fq.gz')}\n")
    cfg = parse_args(["mapcaller", "-i", "x", "-lib", str(lib)])
    assert cfg.read_files1 == [os.path.join(DATA, "sub_r1.fq.gz")]
    assert cfg.read_files2 == [os.path.join(DATA, "sub_r2.fq.gz")]


def test_update_stub(capsys):
    assert main(["mapcaller", "update"]) == 0


def test_version_and_usage():
    assert main(["mapcaller", "-v"]) == 0
    assert main(["mapcaller"]) == 0
    assert main(["mapcaller", "-i", "x"]) == 0  # no reads -> usage


def test_unknown_flag():
    assert parse_args(["mapcaller", "-bogus"]) is None


def test_shards_flag():
    cfg = parse_args(["mapcaller", "-i", "x", "-shards", "8"])
    assert cfg.index_shards == 8
