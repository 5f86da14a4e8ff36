"""x64 big-genome PRODUCTION chain path (parallel/big_index.
build_big_chain_kernel via DeviceBackend with cfg.big_x64): parity vs
the plain single-chip backend and the reference goldens. The >2^31-row
integration proof is scripts/big_genome_proof.py;
these tests force the x64 kernels on small genomes so the full
map+call production semantics are exercised on the 8-device CPU mesh.

Reference behavior being matched: the reference's index types are
uint64 end to end (src/BWT_Index/bwt.h:44), so human-scale texts flow
through the same mapping code; here int64 diagonals/locations must
leave classification and downstream SAM/VCF bit-identical.
"""
import gzip
import os
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")


@pytest.fixture()
def toy_fasta():
    return "/root/reference/test/ref.fa"


def test_big_x64_chain_parity():
    """submit_chain/collect_chain through _BigShardedChain must match
    the single-chip kernel bit for bit, with int64 diagonals."""
    from mapcaller.config import Config
    from mapcaller.index.fmindex import build_index
    from mapcaller.index.packer import PackedReference
    from mapcaller.pipeline.device_backend import DeviceBackend

    rng = np.random.default_rng(21)
    codes = rng.integers(0, 4, size=30000).astype(np.uint8)
    codes[20000:20400] = codes[5000:5400]      # a repeat for slow hits
    idx = build_index(None, packed=PackedReference(
        ["chr1"], [len(codes)], [0], codes, []))
    B, bucket = 256, 128
    mat = np.zeros((B, bucket), np.uint8)
    rlens = np.full(B, 100, np.int32)
    for i in range(B):
        p = int(rng.integers(0, len(codes) - 100))
        r = codes[p:p + 100].copy()
        if i % 3 == 1:
            r[33] = (r[33] + 1) % 4            # SNP -> fast w/ mismatch
        if i % 9 == 4:
            r = np.concatenate([r[:50], codes[p + 52:p + 102]])[:100]
        mat[i, :100] = r
    packed = np.zeros((B, bucket // 4), dtype=np.uint8)
    for j in range(4):
        packed |= (mat[:, j::4] & 3) << (2 * j)

    outs = []
    for shards, big in ((0, False), (8, True)):
        cfg = Config(sam_file="x", vcf_file="v", log_file="l",
                     index_shards=shards, big_x64=big)
        be = DeviceBackend(idx, cfg)
        token = be.submit_chain(packed, rlens, bucket)
        if big:
            assert np.asarray(token[6]).dtype == np.int64   # pd int64
        outs.append(be.collect_chain(token, B,
                                     lambda i: mat[i, :100]))
    for a, b, name in zip(outs[0], outs[1],
                          ("cls", "pd", "mm", "rplast", "cscore", "counts",
                           "rpos", "gpos", "slen")):
        assert np.array_equal(np.asarray(a), np.asarray(b)), name
    assert (np.asarray(outs[0][5]) > 0).any()  # slow hits present


def test_big_x64_stream_golden(tmp_path, toy_fasta):
    """Full production stream (CLI semantics) with big_x64 + 8 shards:
    paired-end subset must match the reference binary's golden SAM+VCF,
    including evidence planes fed int64 diagonals."""
    from mapcaller.config import Config
    from mapcaller.index.fmindex import build_index
    from mapcaller.io.sam import sam_headers
    from mapcaller.pipeline.device_backend import DeviceBackend
    from mapcaller.pipeline.engine import MappingEngine
    from mapcaller.pipeline.stream import run_stream_mapping
    from mapcaller.runner import run_calling

    idx = build_index(toy_fasta)
    data = os.path.join(os.path.dirname(__file__), "data", "subset")
    cfg = Config(sam_file="x", vcf_file=str(tmp_path / "s.vcf"),
                 log_file=str(tmp_path / "s.log"), index_shards=8,
                 big_x64=True)
    backend = DeviceBackend(idx, cfg)
    assert backend.big_x64
    engine = MappingEngine(idx, cfg, backend=backend)
    cfg.read_files1 = [os.path.join(data, "sub_r1.fq.gz")]
    cfg.read_files2 = [os.path.join(data, "sub_r2.fq.gz")]
    parts = []
    run_stream_mapping(engine, cfg, time.time(), parts.append)
    engine.finalize()
    run_calling(engine, cfg, "t")

    sam = sam_headers(engine.genome, "0.9.9.41")
    sam.extend("".join(parts).splitlines())
    want_sam = gzip.open(os.path.join(data, "sub_ref.sam.gz"),
                         "rt").read().splitlines()
    assert sorted(l for l in sam if not l.startswith("@")) == \
        sorted(l for l in want_sam if not l.startswith("@"))
    want_vcf = [l for l in open(os.path.join(data, "sub_ref.vcf"))
                if not l.startswith("##")]
    got_vcf = [l for l in open(cfg.vcf_file) if not l.startswith("##")]
    assert got_vcf == want_vcf


def test_classify_int64_matches_int32():
    """classify_reads is dtype-generic: int64 hit locations (the big-
    genome x64 path) must classify identically to int32 on the same
    hits, and pd0 must come back in the position dtype."""
    import jax.numpy as jnp

    from mapcaller.index.fmindex import build_index, pack_words
    from mapcaller.index.packer import PackedReference
    from mapcaller.ops.chain_device import ChainCtx, classify_reads

    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=4096).astype(np.uint8)
    idx = build_index(None, packed=PackedReference(
        ["c"], [len(codes)], [0], codes, []))
    ctx = ChainCtx.from_host(idx)
    B, rlen, max_len = 32, 100, 128
    mat = np.zeros((B, max_len), np.uint8)
    locs = []
    for i in range(B):
        p = int(rng.integers(0, len(codes) - rlen))
        mat[i, :rlen] = codes[p:p + rlen]
        if i % 2:
            mat[i, 40] = (mat[i, 40] + 1) % 4
        locs.append(p)
    words = pack_words(mat.reshape(-1)).reshape(B, -1)
    rlens = jnp.full(B, rlen, jnp.int32)
    # one full-read hit per read
    hit_read = jnp.arange(B, dtype=jnp.int32)
    hit_rpos = jnp.zeros(B, jnp.int32)
    hit_len = jnp.full(B, 30, jnp.int32)
    keep = jnp.ones(B, bool)
    loc32 = jnp.asarray(np.asarray(locs), jnp.int32)

    r32 = classify_reads(ctx, jnp.asarray(words), rlens, hit_read,
                         hit_rpos, hit_len, loc32, keep, max_len)
    with jax.enable_x64(True):
        loc64 = jnp.asarray(np.asarray(locs, np.int64))
        r64 = classify_reads(ctx, jnp.asarray(words), rlens, hit_read,
                             hit_rpos, hit_len, loc64, keep, max_len)
    assert np.asarray(r64[1]).dtype == np.int64
    for a, b, name in zip(r32, r64, ("cls", "pd", "mm", "rplast",
                                     "cscore", "mmp")):
        assert np.array_equal(np.asarray(a), np.asarray(b)), name


# ---------------------------------------------------------------------------
# genome-sharded evidence planes (pipeline/big_profile.BigDeviceEvidence)
# ---------------------------------------------------------------------------

def _run_big(toy_fasta, tmp_path, tag, **cfg_kw):
    from mapcaller.config import Config
    from mapcaller.index.fmindex import build_index
    from mapcaller.io.sam import sam_headers
    from mapcaller.pipeline.device_backend import DeviceBackend
    from mapcaller.pipeline.engine import MappingEngine
    from mapcaller.pipeline.stream import run_stream_mapping
    from mapcaller.runner import run_calling

    idx = build_index(toy_fasta)
    data = os.path.join(os.path.dirname(__file__), "data", "modes")
    sub = os.path.join(os.path.dirname(__file__), "data", "subset")
    cfg = Config(sam_file="x", vcf_file=str(tmp_path / f"{tag}.vcf"),
                 log_file=str(tmp_path / f"{tag}.log"),
                 batch_size=256, stream_batch_size=256, max_read_len=128,
                 index_shards=8, big_x64=True, **cfg_kw)
    backend = DeviceBackend(idx, cfg)
    engine = MappingEngine(idx, cfg, backend=backend)
    cfg.read_files1 = [os.path.join(sub, "sub_r1.fq.gz")]
    cfg.read_files2 = [os.path.join(sub, "sub_r2.fq.gz")]
    parts = []
    run_stream_mapping(engine, cfg, time.time(), parts.append)
    big_ev = engine.device_evidence
    engine.finalize()
    run_calling(engine, cfg, "t")
    sam = sam_headers(engine.genome, "0.9.9.41")
    sam.extend("".join(parts).splitlines())
    vcf = [l for l in open(cfg.vcf_file) if not l.startswith("##")]
    return sam, vcf, big_ev


def _golden_mode(name):
    data = os.path.join(os.path.dirname(__file__), "data", "modes")
    gs = gzip.open(os.path.join(data, f"{name}.sam.gz"), "rt").read().splitlines()
    gv = [l for l in gzip.open(os.path.join(data, f"{name}.vcf.gz"), "rt")
          .read().splitlines() if not l.startswith("##")]
    return gs, [l + "\n" for l in gv]


@pytest.mark.parametrize("name,cfg_kw", [
    ("gvcf", dict(gvcf=True)),          # NOR kernel over sharded planes
    ("mono", dict(monomorphic=True)),   # dense download fallback
    ("somatic", dict(somatic=True)),    # somatic scan thresholds
    ("ad3", dict(min_allele_depth=3)),
])
def test_big_sharded_planes_mode_parity(toy_fasta, tmp_path, name, cfg_kw):
    """Calling-mode parity through the genome-sharded evidence planes:
    the big_x64 + 8-shard production path must reproduce the reference
    goldens for the modes that stress each sharded kernel (scan, NOR
    segment reduction, full-plane download)."""
    from mapcaller.pipeline.big_profile import BigDeviceEvidence
    sam, vcf, ev = _run_big(toy_fasta, tmp_path, name, **cfg_kw)
    assert isinstance(ev, BigDeviceEvidence)
    gsam, gvcf = _golden_mode(name)
    assert sam == gsam
    assert vcf == gvcf


def test_big_sharded_planes_layout(toy_fasta, tmp_path):
    """Memory contract: every evidence plane is genome-sharded over the
    dp mesh — each device holds exactly a [.., Pl] slice, never the
    full [.., n*Pl] plane (the human-scale HBM constraint)."""
    from mapcaller.pipeline.big_profile import BigDeviceEvidence
    sam, vcf, ev = _run_big(toy_fasta, tmp_path, "layout")
    assert isinstance(ev, BigDeviceEvidence)
    assert ev.Pg == 8 * ev.Pl and ev.Pg >= ev.L + 2
    assert ev.Pl % 400 == 0
    for name in ("acgt", "exact_diff", "f_diff", "multi_diff"):
        a = getattr(ev.planes, name)
        assert a.shape[-1] == ev.Pg
        shards = a.addressable_shards
        assert len(shards) == 8
        for s in shards:
            assert s.data.shape[-1] == ev.Pl, name
    # finalize outputs stay sharded too (no L-sized array on one device)
    acgt_f, F, multi, cov, ccov, cov_tot = ev.finalize()
    for a in (acgt_f, F, multi, cov, ccov):
        for s in a.addressable_shards:
            assert s.data.shape[-1] == ev.Pl
