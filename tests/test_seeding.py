"""Host seeding oracle vs brute-force substring search."""
import numpy as np
import pytest

from mapcaller.dna import decode, encode
from mapcaller.index.fmindex import build_index
from mapcaller.index.packer import PackedReference
from mapcaller.pipeline.seeding import (OCC_THR, MIN_SEED_LEN, bwt_search,
                                            identify_simple_pairs)


def make_idx(codes):
    ref = PackedReference(["chr1"], [len(codes)], [0],
                          np.asarray(codes, dtype=np.uint8), [])
    return build_index(None, packed=ref)


def brute_search(text_str, q, start, stop):
    """Longest prefix of q[start:stop] occurring in text; (len, sorted locs)."""
    best_len = 0
    for l in range(1, stop - start + 1):
        pat = q[start:start + l]
        if pat in text_str:
            best_len = l
        else:
            break
    locs = []
    pat = q[start:start + best_len]
    i = text_str.find(pat)
    while i != -1:
        locs.append(i)
        i = text_str.find(pat, i + 1)
    return best_len, sorted(locs)


@pytest.fixture(scope="module")
def small_idx():
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=2000).astype(np.uint8)
    return make_idx(codes)


def test_bwt_search_matches_bruteforce(small_idx):
    idx = small_idx
    text_str = decode(idx.ref.fwd_rc_codes())
    rng = np.random.default_rng(8)
    # exact substrings plus mutated reads
    for trial in range(30):
        p = int(rng.integers(0, idx.genome_size - 60))
        q_codes = idx.ref.codes[p:p + 50].copy()
        if trial % 2:
            q_codes[int(rng.integers(0, 50))] = rng.integers(0, 4)
        q = decode(q_codes)
        length, locs = bwt_search(idx, q_codes, 0, 50)
        blen, blocs = brute_search(text_str, q, 0, 50)
        assert length == blen
        if blen >= MIN_SEED_LEN and len(blocs) <= OCC_THR:
            assert locs is not None and sorted(locs) == blocs
        else:
            assert locs is None


def test_identify_simple_pairs_covers_read(small_idx):
    idx = small_idx
    p = 700
    q_codes = idx.ref.codes[p:p + 100].copy()
    q_codes[50] = (q_codes[50] + 1) % 4  # one mismatch splits seeds
    pairs = identify_simple_pairs(idx, q_codes)
    assert pairs[-1].gPos == idx.seq_len  # sentinel
    real = pairs[:-1]
    assert len(real) >= 2
    # seeds on the true diagonal exist
    diags = {f.PosDiff for f in real}
    assert p in diags
    # sortedness by (PosDiff, rPos)
    keys = [(f.PosDiff, f.rPos) for f in real]
    assert keys == sorted(keys)
    # every seed is a true match
    text = idx.ref.fwd_rc_codes()
    for f in real:
        assert np.array_equal(text[f.gPos:f.gPos + f.gLen],
                              q_codes[f.rPos:f.rPos + f.rLen])
