"""NW / ksw2 host oracles vs the reference implementation (fuzz).

Requires the compiled harness at /tmp/alntest (built from the reference
sources); skipped when unavailable.
"""
import os
import subprocess

import numpy as np
import pytest

from mapcaller.dna import decode
from mapcaller.ops.ksw2_host import ksw2_alignment
from mapcaller.ops.nw_host import nw_alignment

HARNESS = "/tmp/alntest"


def gen_pairs(n, seed):
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        m = int(rng.integers(1, 60))
        base = rng.integers(0, 4, size=m).astype(np.uint8)
        # derive s2 by mutating s1: subs + indels
        s2 = list(base)
        for _ in range(int(rng.integers(0, 6))):
            op = rng.integers(0, 3)
            pos = int(rng.integers(0, max(1, len(s2))))
            if op == 0 and s2:
                s2[pos] = int(rng.integers(0, 4))
            elif op == 1:
                s2.insert(pos, int(rng.integers(0, 4)))
            elif op == 2 and len(s2) > 1:
                del s2[pos]
        if not s2:
            s2 = [0]
        pairs.append((decode(base), decode(np.array(s2, dtype=np.uint8))))
    return pairs


def run_harness(mode, pairs):
    inp = "".join(f"{a} {b}\n" for a, b in pairs)
    out = subprocess.run([HARNESS, mode], input=inp, capture_output=True,
                         text=True, check=True).stdout
    return [tuple(line.split()) for line in out.strip().split("\n")]


@pytest.mark.skipif(not os.path.exists(HARNESS), reason="reference harness missing")
def test_nw_matches_reference():
    pairs = gen_pairs(300, 5)
    expected = run_harness("nw", pairs)
    for (s1, s2), (e1, e2) in zip(pairs, expected):
        a1, a2 = nw_alignment(s1, s2)
        assert (a1, a2) == (e1, e2), (s1, s2)


@pytest.mark.skipif(not os.path.exists(HARNESS), reason="reference harness missing")
def test_ksw2_matches_reference():
    pairs = gen_pairs(300, 6)
    expected = run_harness("ksw2", pairs)
    for (s1, s2), (e1, e2) in zip(pairs, expected):
        a1, a2 = ksw2_alignment(s1, s2)
        assert (a1, a2) == (e1, e2), (s1, s2)


def test_nw_basics():
    assert nw_alignment("TTACG", "TTCG") == ("TTACG", "TT-CG")
    assert nw_alignment("ACGTACGT", "ACGTCGT") == ("ACGTACGT", "ACGT-CGT")
    assert nw_alignment("AAAA", "TTTT") == ("AAAA", "TTTT")


def test_ksw2_basics():
    assert ksw2_alignment("TTACG", "TTCG") == ("TTACG", "TT-CG")
    assert ksw2_alignment("ACGTACGT", "ACGTCGT") == ("ACGTACGT", "ACGT-CGT")
