"""Vectorized genome-scan caller vs the scalar reference mirror."""
import numpy as np
import pytest

from mapcaller.config import Config
from mapcaller.calling.caller import (_identify_variants_scalar,
                                          _identify_variants_vec,
                                          cal_block_read_depth)
from mapcaller.genome import Genome
from mapcaller.index.packer import PackedReference
from mapcaller.pipeline.profile import Profile


def _random_profile(rng, L, sparse=False):
    prof = Profile(L)
    ref = rng.integers(0, 4, size=L).astype(np.uint8)
    # coverage in patches; leave gaps and multi-hit runs
    n_patch = 40
    for _ in range(n_patch):
        s = int(rng.integers(0, L - 200))
        ln = int(rng.integers(20, 200))
        depth = int(rng.integers(1, 30))
        for c in range(4):
            prof.acgt[c, s:s + ln] = rng.integers(0, 3, size=ln)
        # ref base dominates
        idx = np.arange(s, s + ln)
        prof.acgt[ref[idx], idx] += depth
    # sprinkle SNV evidence (single and double alt)
    for _ in range(60):
        p = int(rng.integers(0, L))
        alt = int(rng.integers(0, 4))
        prof.acgt[alt, p] += int(rng.integers(3, 25))
    for _ in range(10):
        p = int(rng.integers(0, L))
        a1, a2 = rng.choice(4, size=2, replace=False)
        prof.acgt[a1, p] += int(rng.integers(5, 20))
        prof.acgt[a2, p] += int(rng.integers(5, 20))
    # multi-hit (CNV) runs of varying lengths incl. > 50
    for ln in (10, 49, 50, 51, 80, 200):
        s = int(rng.integers(0, L - ln))
        zone = slice(s, s + ln)
        prof.acgt[:, zone] = 0
        prof.multi_hit[zone] = 1
    # indel evidence clusters (within +-5 windows, competing keys)
    for _ in range(25):
        p = int(rng.integers(5, L - 5))
        for dk in range(int(rng.integers(1, 3))):
            k = p + int(rng.integers(-5, 6))
            seq = "".join("ACGT"[int(b)] for b in rng.integers(0, 4, size=int(rng.integers(1, 4))))
            tbl = prof.insert_map if rng.random() < 0.5 else prof.delete_map
            tbl.setdefault(k, {})
            tbl[k][seq] = tbl[k].get(seq, 0) + int(rng.integers(1, 20))
    # trailing gap to check the never-flushed tail
    prof.acgt[:, L - 120:] = 0
    prof.multi_hit[L - 120:] = 0
    return prof, ref


def _genome(L):
    ref = PackedReference(["chr1"], [L], [0],
                          np.zeros(L, dtype=np.uint8), [])
    return Genome.from_packed(ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(somatic=True),
    dict(ploidy=1),
    dict(min_unmapped_size=30, min_cnv_size=30),
])
def test_vec_matches_scalar(seed, kwargs):
    rng = np.random.default_rng(seed)
    L = 20000
    prof, ref = _random_profile(rng, L)
    genome = _genome(L)
    cfg = Config(**kwargs)
    bd = cal_block_read_depth(prof, L)
    want = _identify_variants_scalar(cfg, genome, prof, ref, bd)
    got = _identify_variants_vec(cfg, genome, prof, ref, bd)
    assert [vars(v) for v in got] == [vars(v) for v in want]


@pytest.mark.parametrize("gvcf,mono,somatic,ploidy", [
    (True, False, False, 2),
    (True, False, True, 2),
    (False, True, False, 2),
    (False, True, False, 1),
    (True, True, False, 2),
])
def test_gvcf_vec_matches_scalar(gvcf, mono, somatic, ploidy):
    from mapcaller.calling.caller import _identify_variants_gvcf_vec
    rng = np.random.default_rng(77 + ploidy + 2 * gvcf + 4 * mono)
    L = 4000
    prof, ref = _random_profile(rng, L)
    genome = _genome(L)
    cfg = Config(vcf_file="x", log_file="x", gvcf=gvcf, monomorphic=mono,
                 somatic=somatic, ploidy=ploidy)
    bd = cal_block_read_depth(prof, L)
    want = _identify_variants_scalar(cfg, genome, prof, ref, bd)
    got = _identify_variants_gvcf_vec(cfg, genome, prof, ref, bd)

    def key(v):
        return (v.gPos, v.VarType, v.DP, v.AD_ref, v.AD_alt, v.GenoType,
                v.qscore, v.ALTstr)

    kw, kg = [key(v) for v in want], [key(v) for v in got]
    assert kw == kg, (len(kw), len(kg),
                      [x for x, y in zip(kw, kg) if x != y][:3])
    assert len(kw) > 10
