"""The folded (speculative) evidence apply in the chain kernel must be
bit-identical to the stand-alone apply path, and the sparse reject
correction must be an exact retraction."""
import numpy as np
import pytest

from mapcaller.index.fmindex import build_index
from mapcaller.index.packer import PackedReference
from mapcaller.ops.chain_device import CLASS_FAST, ChainCtx
from mapcaller.ops.fm3_device import DeviceFM3
from mapcaller.ops.fm_search import build_seed_chain_kernel
from mapcaller.pipeline.device_profile import (
    DevicePlanes, build_apply_kernel, build_correct_kernel)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, size=20000).astype(np.uint8)
    idx = build_index(None, packed=PackedReference(
        ["chr1"], [len(codes)], [0], codes, []))
    B, bucket = 128, 128
    mat = np.zeros((B, bucket), dtype=np.uint8)
    rlens = np.full(B, 100, dtype=np.int32)
    for b in range(B):
        p = int(rng.integers(0, len(codes) - 100))
        r = codes[p:p + 100].copy()
        if b % 3 == 1:                       # SNP -> fast w/ mismatch
            r[40] = (r[40] + 1) % 4
        if b % 7 == 3:                       # rc strand
            r = (3 - r)[::-1]
        mat[b, :100] = r
    packed = np.zeros((B, bucket // 4), dtype=np.uint8)
    for j in range(4):
        packed |= (mat[:, j::4] & 3) << (2 * j)
    return idx, packed, rlens, B, bucket


def _planes_np(planes):
    return tuple(np.asarray(x) for x in (planes.exact_diff, planes.f_diff,
                                         planes.acgt, planes.multi_diff))


@pytest.mark.parametrize("pair_end", [False, True])
def test_folded_apply_bit_identical(setup, pair_end):
    import jax.numpy as jnp
    idx, packed, rlens, B, bucket = setup
    fm3 = DeviceFM3.from_host(idx)
    ctx = ChainCtx.from_host(idx)
    L, two_l = idx.genome_size, ctx.seq_len

    plain = build_seed_chain_kernel(fm3, ctx, bucket, B)
    dev, pd, mmp = plain(jnp.asarray(packed), jnp.asarray(rlens))
    cls = np.asarray(dev)[:B] & 3
    assert (cls == CLASS_FAST).sum() >= B // 2

    # oracle: plain kernel + dense meta-source apply
    kern_meta = build_apply_kernel(L, two_l, B, pair_end, source="meta")
    want = kern_meta(DevicePlanes.zeros(L), pd, mmp, jnp.asarray(rlens), dev)

    folded = build_seed_chain_kernel(fm3, ctx, bucket, B, with_planes=True,
                                     pair_end=pair_end)
    dev2, pd2, mmp2, got = folded(jnp.asarray(packed), jnp.asarray(rlens),
                                  DevicePlanes.zeros(L))
    assert np.array_equal(np.asarray(dev2), np.asarray(dev))
    for a, b in zip(_planes_np(want), _planes_np(got)):
        assert np.array_equal(a, b)

    # sparse correction: retract every 5th fast read == bits-apply of the
    # remaining admitted set
    fast_ix = np.nonzero(cls == CLASS_FAST)[0]
    rej = fast_ix[::5].astype(np.int32)
    R = 64
    rej_pad = np.full(R, B, dtype=np.int32)
    rej_pad[:rej.size] = rej
    corr = build_correct_kernel(L, two_l, B, pair_end, R)
    got2 = corr(got, pd2, mmp2, jnp.asarray(rlens), jnp.asarray(rej_pad))

    adm = np.zeros(B, dtype=bool)
    adm[fast_ix] = True
    adm[rej] = False
    bits = np.zeros((B + 31) // 32, dtype=np.int32)
    for i in np.nonzero(adm)[0]:
        bits[i >> 5] |= np.int32(1 << (i & 31))
    kern_bits = build_apply_kernel(L, two_l, B, pair_end, source="bits")
    want2 = kern_bits(DevicePlanes.zeros(L), pd, mmp, jnp.asarray(rlens),
                      jnp.asarray(bits))
    for a, b in zip(_planes_np(want2), _planes_np(got2)):
        assert np.array_equal(a, b)


def _stream_run(idx, cfg, f1, f2=None):
    import time

    from mapcaller.pipeline.device_backend import DeviceBackend
    from mapcaller.pipeline.engine import MappingEngine
    from mapcaller.pipeline.stream import run_stream_mapping
    from mapcaller.runner import run_calling
    backend = DeviceBackend(idx, cfg)
    engine = MappingEngine(idx, cfg, backend=backend)
    cfg.read_files1, cfg.read_files2 = [f1], ([f2] if f2 else [])
    parts = []
    run_stream_mapping(engine, cfg, time.time(), parts.append)
    engine.finalize()
    run_calling(engine, cfg, "t")
    vcf = [l for l in open(cfg.vcf_file) if not l.startswith("##")]
    return "".join(parts), vcf, backend


def test_fold_stream_parity_pe(tmp_path, toy_fasta):
    """fold_evidence=True must leave the full paired-end stream output
    bit-identical: speculative apply + sparse dup-gate retraction."""
    import os

    from mapcaller.config import Config
    idx = build_index(toy_fasta)
    data = os.path.join(os.path.dirname(__file__), "data", "subset")
    outs = []
    for fold in (False, True):
        cfg = Config(sam_file="x", vcf_file=str(tmp_path / f"{fold}.vcf"),
                     log_file=str(tmp_path / f"{fold}.log"),
                     fold_evidence=fold)
        outs.append(_stream_run(idx, cfg,
                                os.path.join(data, "sub_r1.fq.gz"),
                                os.path.join(data, "sub_r2.fq.gz")))
    assert outs[0][0] == outs[1][0]
    assert outs[0][1] == outs[1][1] and len(outs[0][1]) > 50


def test_fold_tier_rerun_undo(tmp_path):
    """When a hit-buffer rerun invalidates the folded speculation, the
    dense undo + classic apply must restore bit-exact evidence."""
    from mapcaller.config import Config
    from mapcaller.dna import decode
    rng = np.random.default_rng(33)
    unit = rng.integers(0, 4, 500).astype(np.uint8)
    genome = np.concatenate([rng.integers(0, 4, 4000).astype(np.uint8),
                             unit, unit, unit,
                             rng.integers(0, 4, 4000).astype(np.uint8)])
    idx = build_index(None, packed=PackedReference(
        ["chr1"], [len(genome)], [0], genome, []))
    fq = tmp_path / "m.fq"
    with open(fq, "w") as f:
        for k in range(1024):
            if k % 2 == 0:
                p = int(rng.integers(4000, 4000 + 3 * 500 - 100))
            else:
                p = int(rng.integers(0, len(genome) - 100))
            c = genome[p:p + 100].copy()
            if k % 11 == 5:
                c[50] = (c[50] + 1) % 4
            f.write(f"@m{k}\n{decode(c)}\n+\n{'I' * 100}\n")
    outs = []
    for fold in (False, True):
        cfg = Config(sam_file="x", vcf_file=str(tmp_path / f"r{fold}.vcf"),
                     log_file=str(tmp_path / f"r{fold}.log"),
                     batch_size=1024, stream_batch_size=1024,
                     max_read_len=256, fold_evidence=fold)
        outs.append(_stream_run(idx, cfg, str(fq)))
    assert outs[1][2].n_tier_reruns > 0, "fixture must exercise the undo"
    assert outs[0][0] == outs[1][0]
    assert outs[0][1] == outs[1][1]
