"""Index construction tests: suffix array, BWT, Occ, SA sampling against
brute-force oracles, and (when the reference binary's index files exist)
byte-level parity with bwa-format .bwt/.sa."""
import os

import numpy as np
import pytest

from mapcaller.dna import decode, encode, revcomp_codes
from mapcaller.index.suffix import build_suffix_array, bwt_from_sa
from mapcaller.index.fmindex import FMIndex, build_index, load_index, pack_words
from mapcaller.index.packer import PackedReference, pack_fasta


def brute_suffix_array(text):
    s = bytes(text)
    return np.array(sorted(range(len(s)), key=lambda i: s[i:]), dtype=np.int64)


def make_ref(codes):
    return PackedReference(["chr1"], [len(codes)], [0],
                           np.asarray(codes, dtype=np.uint8), [])


@pytest.mark.parametrize("n", [1, 2, 7, 64, 301])
def test_suffix_array_matches_bruteforce(n, rng=np.random.default_rng(0)):
    text = rng.integers(0, 4, size=n).astype(np.uint8)
    assert np.array_equal(build_suffix_array(text), brute_suffix_array(text))


def test_bwt_and_primary():
    # classic example: text "ACAACG" -> check BWT against direct rotation sort
    text = encode("ACAACG")
    sa = build_suffix_array(text)
    bwt, primary = bwt_from_sa(text, sa)
    # brute force: rows of T$ sorted, '$'<A
    s = "ACAACG$"
    rows = sorted(range(len(s)), key=lambda i: s[i:])
    full_bwt = [s[r - 1] for r in rows]
    assert full_bwt[primary] == "$"
    stripped = [c for c in full_bwt if c != "$"]
    assert decode(bwt) == "".join(stripped)


def test_occ_against_bruteforce():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, size=333).astype(np.uint8)
    idx = build_index(None, packed=make_ref(codes))
    text = idx.ref.fwd_rc_codes()
    n = idx.seq_len
    sa_full = np.concatenate([[n], build_suffix_array(text)])
    full_bwt = np.where(sa_full > 0, text[sa_full - 1], 99)  # 99 = '$'
    stripped = full_bwt[full_bwt != 99]
    # occ(k, c) counts c in stripped[0..k'] with k' = k - (k >= primary)
    for k in [-1, 0, 1, 5, 127, 128, 129, 200, n - 1, n]:
        for c in range(4):
            if k == -1:
                expect = 0
            elif k == n:
                expect = int(idx.L2[c + 1] - idx.L2[c])
            else:
                kk = k - (k >= idx.primary)
                expect = int(np.sum(stripped[: kk + 1] == c))
            assert idx.occ(k, c) == expect, (k, c)
        if 0 <= k < n:
            assert np.array_equal(idx.occ4(k),
                                  [idx.occ(k, c) for c in range(4)])


def test_sa_lookup_roundtrip():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, size=500).astype(np.uint8)
    idx = build_index(None, packed=make_ref(codes))
    text = idx.ref.fwd_rc_codes()
    sa = build_suffix_array(text)
    # full row r (1..n) has suffix position sa[r-1]
    for r in [1, 2, 33, 64, 100, 777, idx.seq_len]:
        assert idx.sa_lookup(r) == int(sa[r - 1])


def test_pack_words_roundtrip():
    codes = np.arange(40, dtype=np.uint8) % 4
    words = pack_words(codes)
    for k in range(40):
        assert (int(words[k >> 4]) >> ((~k & 0xF) << 1)) & 3 == codes[k]


def test_toy_fasta_pack(toy_fasta):
    ref = pack_fasta(toy_fasta)
    assert ref.names == ["TestGenome"]
    assert ref.genome_size == ref.lengths[0]
    # file is 1001 lines x 70bp (last line may differ)
    assert 69000 < ref.genome_size < 71000


def test_save_load_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=200).astype(np.uint8)
    idx = build_index(None, packed=make_ref(codes))
    idx.save(str(tmp_path / "t"))
    idx2 = load_index(str(tmp_path / "t"))
    assert idx2.primary == idx.primary
    assert np.array_equal(idx2.bwt_words, idx.bwt_words)
    assert np.array_equal(idx2.sa_samp, idx.sa_samp)
    assert idx2.ref.names == ["chr1"]


def test_occ3_persisted_with_prefix(tmp_path, monkeypatch):
    """With MC_PERSIST_OCC3, build_index(prefix) precomputes the occ3
    seeding table (mirrors the reference interleaving Occ checkpoints
    into the stored .bwt, ref: src/BWT_Index/bwtindex.c:53-75);
    load_index memmaps it and the persisted table is identical to a
    fresh rebuild. (Off by default — the production path derives the
    table on device, tests/test_fm3_device_build.py.)"""
    from mapcaller.index.occ3 import build_occ3
    monkeypatch.setenv("MC_PERSIST_OCC3", "1")
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=3000).astype(np.uint8)
    idx = build_index(None, packed=make_ref(codes), prefix=str(tmp_path / "t"))
    assert os.path.exists(str(tmp_path / "t") + ".occ3.bin")
    idx2 = load_index(str(tmp_path / "t"))
    assert idx2.occ3_table is not None
    fresh = build_occ3(idx.sa_full, idx.ref.fwd_rc_codes())
    for f in ("row_p1", "row_p2", "t0", "t1", "tail1", "tail2a", "tail2b"):
        assert getattr(idx2.occ3_table, f) == getattr(fresh, f)
    assert np.array_equal(np.asarray(idx2.occ3_table.rows), fresh.rows)
    assert np.array_equal(np.asarray(idx2.occ3_table.c3_first),
                          fresh.c3_first)


BWA_PREFIX = "/tmp/refbuild/test/RefIdx"


@pytest.mark.skipif(not os.path.exists(BWA_PREFIX + ".bwt"),
                    reason="reference-built bwa index not available")
def test_parity_with_bwa_index(toy_fasta):
    """Compare our BWT/primary/SA against the reference binary's index
    (bwa format: .bwt = primary + L2[1..4] + interleaved occ/bwt words;
    .sa = primary + L2 + sa_intv + seq_len + samples)."""
    idx = build_index(toy_fasta)
    raw = np.fromfile(BWA_PREFIX + ".bwt", dtype=np.uint8)
    primary = int(np.frombuffer(raw[:8], dtype=np.uint64)[0])
    L2 = np.frombuffer(raw[8:40], dtype=np.uint64)
    assert primary == idx.primary
    assert np.array_equal(L2, idx.L2[1:].astype(np.uint64))
    body = np.frombuffer(raw[40:], dtype=np.uint32)
    # interleaved: every 128 bases preceded by 4 uint64 (8 uint32) occ counts
    n = idx.seq_len
    n_blocks = (n + 127) // 128
    words_per_block = 8  # 128 bases / 16 per word
    pos = 0
    got_words = []
    for b in range(n_blocks):
        ck = np.frombuffer(body[pos:pos + 8].tobytes(), dtype=np.uint64)
        assert np.array_equal(ck, idx.ckpt[b].astype(np.uint64)), b
        pos += 8
        remaining_words = min(words_per_block, (n + 15) // 16 - b * words_per_block)
        got_words.append(body[pos:pos + remaining_words])
        pos += remaining_words
    got_words = np.concatenate(got_words)
    assert np.array_equal(got_words, idx.bwt_words)

    sa_raw = np.fromfile(BWA_PREFIX + ".sa", dtype=np.uint64)
    sa_primary, sa_intv, sa_len = int(sa_raw[0]), int(sa_raw[5]), int(sa_raw[6])
    assert sa_primary == idx.primary and sa_intv == 32 and sa_len == n
    samples = sa_raw[7:].astype(np.int64)
    assert np.array_equal(samples, idx.sa_samp[1:])
