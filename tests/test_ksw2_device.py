"""Device ksw2 kernel vs the host oracle (exact aligned strings)."""
import numpy as np
import pytest

from mapcaller.dna import decode
from mapcaller.ops.ksw2_device import ksw2_align_batch
from mapcaller.ops.ksw2_host import ksw2_alignment


def _rand_pair(rng, max_len=60):
    m = int(rng.integers(1, max_len))
    base = rng.integers(0, 4, size=m).astype(np.uint8)
    s2 = []
    for b in base:
        r = rng.random()
        if r < 0.08:
            continue
        if r < 0.16:
            s2.append(int(rng.integers(0, 4)))
        if r < 0.24:
            s2.append((int(b) + 1) % 4)
        else:
            s2.append(int(b))
    if not s2:
        s2 = [0]
    return decode(base), decode(np.array(s2, dtype=np.uint8))


def test_device_ksw2_matches_host_oracle(rng):
    pairs = [_rand_pair(rng) for _ in range(150)]
    pairs += [("A", "A"), ("A", "C"), ("ACGT", "ACGT"), ("AAAA", "AA"),
              ("AC", "ACGTACGT"), ("G", "TTTT"),
              ("ACGTNACGT", "ACGTACGT")]          # wildcard base
    got = ksw2_align_batch(pairs, M=96, N=96)
    for (s1, s2), (a1, a2) in zip(pairs, got):
        w1, w2 = ksw2_alignment(s1, s2)
        assert (a1, a2) == (w1, w2), (s1, s2, a1, a2, w1, w2)
