"""Batched NW extension kernel (plain JAX) vs the host oracle (exact strings)."""
import numpy as np
import pytest

from mapcaller.dna import decode
from mapcaller.ops.nw_device import nw_align_batch
from mapcaller.ops.nw_host import nw_alignment


def _rand_pair(rng, max_len=60):
    m = int(rng.integers(1, max_len))
    base = rng.integers(0, 4, size=m).astype(np.uint8)
    # s2 = mutated copy (subs + indels) so alignments are non-trivial
    s2 = []
    for b in base:
        r = rng.random()
        if r < 0.08:
            continue                      # deletion
        if r < 0.16:
            s2.append(int(rng.integers(0, 4)))   # insertion
        if r < 0.24:
            s2.append((int(b) + 1) % 4)   # substitution
        else:
            s2.append(int(b))
    if not s2:
        s2 = [0]
    return decode(base), decode(np.array(s2, dtype=np.uint8))


def test_pallas_nw_matches_host_oracle(rng):
    pairs = [_rand_pair(rng) for _ in range(200)]
    pairs += [("A", "A"), ("A", "C"), ("ACGT", "ACGT"), ("AAAA", "AA"),
              ("AC", "ACGTACGT"), ("G", "TTTT")]
    got, scores = nw_align_batch(pairs, M=64, N=96)
    for (s1, s2), (a1, a2) in zip(pairs, got):
        w1, w2 = nw_alignment(s1, s2)
        assert (a1, a2) == (w1, w2), (s1, s2, a1, a2, w1, w2)


def test_pallas_nw_scores(rng):
    pairs = [_rand_pair(rng, max_len=40) for _ in range(40)]
    got, scores = nw_align_batch(pairs, M=48, N=64)
    for (s1, s2), sc, (a1, a2) in zip(pairs, scores, got):
        # recompute the x2-scaled global score from the aligned strings
        exp = 0
        in_r = in_t = False
        for x, y in zip(a1, a2):
            if x == "-":
                exp += -1 if in_r else -3
                in_r, in_t = True, False
            elif y == "-":
                exp += -1 if in_t else -3
                in_r, in_t = False, True
            else:
                exp += 2 if x == y else -2
                in_r = in_t = False
        assert int(sc) == exp, (s1, s2, int(sc), exp)
