"""Device kernels against their host oracles at the widths the CLI runs.

Marked `gpu`: they skip on the CPU and run on the card through
`python chip_smoke.py` (or `JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/test_gpu_parity.py`). Every comparison is exact.
"""
import numpy as np
import pytest

from mapcaller.config import Config
from mapcaller.dna import decode
from mapcaller.index.fmindex import build_index
from mapcaller.index.packer import PackedReference

pytestmark = pytest.mark.gpu

GENOME_LEN = 1_000_000
STREAM_BATCH = 131072          # the auto-compaction stream batch
COMPACT = 4                    # -> 32768 scan lanes


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(2024)
    codes = rng.integers(0, 4, size=GENOME_LEN).astype(np.uint8)
    ref = PackedReference(["chr1"], [GENOME_LEN], [0], codes, [])
    return build_index(None, packed=ref), codes


def _sample_reads(codes, n, rng, rl=100, err=0.01):
    """n reads of length rl from either strand with substitutions."""
    pos = rng.integers(0, codes.size - rl, size=n)
    reads = codes[pos[:, None] + np.arange(rl)[None, :]]
    rc = rng.random(n) < 0.5
    reads[rc] = 3 - reads[rc, ::-1]
    flip = rng.random(reads.shape) < err
    reads[flip] = (reads[flip] + rng.integers(1, 4, size=int(flip.sum()))) % 4
    return reads.astype(np.uint8)


def test_seed_scan_matches_host_oracle(genome):
    """Compacted occ3 seed scan with the auto prefix skip, one full
    131k-read stream batch, against pipeline/seeding.identify_simple_pairs
    on a spread sample of its reads."""
    from mapcaller.pipeline.device_backend import DeviceBackend
    idx, codes = genome
    rng = np.random.default_rng(1)
    cfg = Config(compact_factor=COMPACT, stream_batch_size=STREAM_BATCH,
                 batch_size=STREAM_BATCH, vcf_output=False)
    be = DeviceBackend(idx, cfg)
    reads = _sample_reads(codes, STREAM_BATCH, rng)
    bucket = 128
    mat = np.zeros((STREAM_BATCH, bucket), dtype=np.uint8)
    mat[:, :reads.shape[1]] = reads
    packed = np.zeros((STREAM_BATCH, bucket // 4), dtype=np.uint8)
    for j in range(4):
        packed |= (mat[:, j::4] & 3) << (2 * j)
    rlens = np.full(STREAM_BATCH, reads.shape[1], dtype=np.int32)
    token = be.submit_packed(packed, rlens, bucket)
    counts, rpos, gpos, slen = be.collect_packed(
        token, STREAM_BATCH, lambda i: reads[i])
    assert be.pfx_k is not None and be.pfx_k >= 8
    bounds = np.concatenate([[0], np.cumsum(counts)])
    for i in range(0, STREAM_BATCH, STREAM_BATCH // 1500):
        s, e = bounds[i], bounds[i + 1]
        got = sorted(zip(rpos[s:e].tolist(), gpos[s:e].tolist(),
                         slen[s:e].tolist()))
        orp, ogp, oln = be._oracle_arrays(reads[i])
        want = sorted(zip(orp.tolist(), ogp.tolist(), oln.tolist()))
        assert got == want, i


def test_map_call_matches_host_oracle(genome, tmp_path):
    """Seed+chain/classify, the HBM evidence apply, finalize and the
    caller scan at the compacted stream widths: SAM and VCF of the
    device stream path equal the host oracle's."""
    from mapcaller.runner import run_pipeline
    idx, codes = genome
    prefix = str(tmp_path / "idx")
    idx.save(prefix)
    rng = np.random.default_rng(2)
    n_pairs = 4000
    frag = 300
    starts = rng.integers(0, codes.size - frag, size=n_pairs)
    mut = codes.copy()
    snv = rng.integers(0, codes.size, size=200)
    mut[snv] = (mut[snv] + 1) % 4
    with open(tmp_path / "r1.fq", "w") as f1, open(tmp_path / "r2.fq", "w") as f2:
        for k, p in enumerate(starts.tolist()):
            a = mut[p:p + 100]
            b = 3 - mut[p + frag - 100:p + frag][::-1]
            f1.write(f"@p{k}/1\n{decode(a)}\n+\n{'I' * 100}\n")
            f2.write(f"@p{k}/2\n{decode(b)}\n+\n{'I' * 100}\n")
    outs = {}
    for backend in ("device", "host"):
        cfg = Config(index_prefix=prefix,
                     read_files1=[str(tmp_path / "r1.fq")],
                     read_files2=[str(tmp_path / "r2.fq")],
                     sam_file=str(tmp_path / f"{backend}.sam"),
                     vcf_file=str(tmp_path / f"{backend}.vcf"),
                     log_file=str(tmp_path / f"{backend}.log"),
                     backend=backend, compact_factor=COMPACT,
                     stream_batch_size=STREAM_BATCH)
        assert run_pipeline(cfg, "mapcaller") == 0
        outs[backend] = ((tmp_path / f"{backend}.sam").read_bytes(),
                         (tmp_path / f"{backend}.vcf").read_bytes())
    assert outs["device"][0] == outs["host"][0]
    assert outs["device"][1] == outs["host"][1]
    assert outs["device"][1].count(b"\n") > 100


def _dp_pairs(rng, n, max_len):
    pairs = []
    for _ in range(n):
        m = int(rng.integers(1, max_len + 1))
        base = rng.integers(0, 4, size=m).astype(np.uint8)
        s2 = []
        for b in base:
            r = rng.random()
            if r < 0.06:
                continue
            if r < 0.12:
                s2.append(int(rng.integers(0, 4)))
            s2.append((int(b) + 1) % 4 if r < 0.2 else int(b))
        s2 = s2[:max_len] or [0]
        pairs.append((decode(base), decode(np.array(s2, dtype=np.uint8))))
    return pairs


@pytest.mark.parametrize("width", [32, 48, 96])
def test_nw_matches_host_oracle(width):
    from mapcaller.ops.nw_device import nw_align_batch
    from mapcaller.ops.nw_host import nw_alignment
    pairs = _dp_pairs(np.random.default_rng(width), 600, width)
    got, _ = nw_align_batch(pairs, M=width, N=width)
    for (s1, s2), aln in zip(pairs, got):
        assert aln == nw_alignment(s1, s2), (s1, s2)


@pytest.mark.parametrize("width", [32, 48, 96])
def test_ksw2_matches_host_oracle(width):
    from mapcaller.ops.ksw2_device import ksw2_align_batch
    from mapcaller.ops.ksw2_host import ksw2_alignment
    pairs = _dp_pairs(np.random.default_rng(100 + width), 600, width)
    got = ksw2_align_batch(pairs, M=width, N=width)
    for (s1, s2), aln in zip(pairs, got):
        assert aln == ksw2_alignment(s1, s2), (s1, s2)
