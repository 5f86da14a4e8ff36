"""Multichip device map step on the virtual 8-device CPU mesh."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from mapcaller.index.fmindex import build_index
from mapcaller.index.packer import PackedReference
from mapcaller.ops.fm_device import DeviceFMIndex
from mapcaller.parallel.mesh import build_multichip_map_step, make_mesh


def _pack2(codes):
    B, W = codes.shape
    out = np.zeros((B, W // 4), dtype=np.uint8)
    for j in range(4):
        out |= (codes[:, j::4] & 3) << (2 * j)
    return out


@pytest.mark.parametrize("n_devices", [2, 8])
def test_mesh_map_step_coverage(n_devices, rng):
    codes = rng.integers(0, 4, size=30000).astype(np.uint8)
    ref = PackedReference(["chr1"], [len(codes)], [0], codes, [])
    idx = build_index(None, packed=ref)
    fm = DeviceFMIndex.from_host(idx)
    mesh = make_mesh(n_devices)
    PER_DEV, MAXLEN = 16, 64
    step = build_multichip_map_step(fm, MAXLEN, PER_DEV, n_devices, mesh)

    B = PER_DEV * n_devices
    reads = np.zeros((B, MAXLEN), dtype=np.uint8)
    rlens = np.full(B, 48, dtype=np.int32)
    starts = []
    for b in range(B):
        p = int(rng.integers(0, idx.genome_size - 48))
        starts.append(p)
        reads[b, :48] = codes[p:p + 48]
    packed = jax.device_put(jnp.asarray(_pack2(reads)),
                            NamedSharding(mesh, P("dp", None)))
    rl = jax.device_put(jnp.asarray(rlens), NamedSharding(mesh, P("dp")))
    cov_shard, n_hits = step(packed, rl)
    cov = np.asarray(cov_shard)
    assert int(n_hits) >= B
    # every sampled 48-mer contributes forward coverage over its span
    for p in starts:
        assert cov[p:p + 48].min() >= 1, p
    # total coverage equals the sum of forward-hit span lengths
    assert cov.sum() >= B * 48


def test_multichip_pipeline_bit_identical():
    """The full production pipeline over an 8-device mesh produces a
    variant set bit-identical to the single-device run (VERDICT round-1
    item 4): device mismatch evidence, host slow path (DEL), and
    gap/CNV runs crossing the genome-shard seams. Includes the
    paired-end phase: per-shard C++ host pipeline in ops mode with the
    admit-bitmask round trip into the phase-B mesh evidence kernel."""
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


def test_multichip_pipeline_two_devices():
    import __graft_entry__ as ge
    ge.dryrun_multichip(2)


def test_sharded_index_seeding():
    """Genome-sharded FM-index: occ3 rows split over the 8-device mesh,
    seed-scan row gathers routed via all_gather + local answer + psum —
    the per-read seed tables must equal the replicated-index kernel's."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mapcaller.index.fmindex import build_index
    from mapcaller.index.packer import PackedReference
    from mapcaller.ops.fm3_device import DeviceFM3
    from mapcaller.ops.fm_search import MIN_SEED_LEN, _seed_scan3
    from mapcaller.parallel.mesh import make_mesh
    from mapcaller.parallel.sharded_index import (build_sharded_seed_scan,
                                                      shard_occ3_rows)

    rng = np.random.default_rng(17)
    L = 12000
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    ref = PackedReference(["chr1"], [L], [0], codes, [])
    idx = build_index(None, packed=ref)
    fm3 = DeviceFM3.from_host(idx)
    n_dev = 8
    mesh = make_mesh(n_dev)
    B, MAXLEN = 16, 64
    BG = B * n_dev
    text = idx.ref.fwd_rc_codes()
    mat = np.zeros((BG, MAXLEN), dtype=np.uint8)
    rlens = np.full(BG, 60, dtype=np.int32)
    for b in range(BG):
        p = int(rng.integers(0, idx.genome_size - 60))
        r = text[p:p + 60].copy()
        if b % 3 == 0:
            j = int(rng.integers(0, 60))
            r[j] = (r[j] + 1 + rng.integers(0, 3)) % 4
        mat[b, :60] = r
    packed = np.zeros((BG, MAXLEN // 4), dtype=np.uint8)
    for j in range(4):
        packed |= (mat[:, j::4] & 3) << (2 * j)

    slices, rps = shard_occ3_rows(fm3, n_dev)
    step = build_sharded_seed_scan(fm3, mesh, n_dev, MAXLEN, B)
    occ_s = jax.device_put(jnp.asarray(slices),
                           NamedSharding(mesh, P("dp", None, None)))
    pk = jax.device_put(jnp.asarray(packed), NamedSharding(mesh, P("dp", None)))
    rl = jax.device_put(jnp.asarray(rlens), NamedSharding(mesh, P("dp")))
    got = jax.device_get(step(occ_s, pk, rl))

    # replicated-index oracle: the same scan, plain gathers
    max_seeds = MAXLEN // (MIN_SEED_LEN + 1) + 2

    @jax.jit
    def ref_scan(fm3, packed, rlens):
        W4 = packed.shape[1]
        nwords = (W4 + 3) // 4
        pb = packed.astype(jnp.uint32).reshape(BG, nwords, 4)
        sh = (jnp.arange(4, dtype=jnp.uint32) * 8)[None, None, :]
        words = (pb << sh).sum(axis=2, dtype=jnp.uint32)
        widx = jnp.arange(nwords, dtype=jnp.int32)[None, :]

        def codes_fn(row, pos):
            wi = (pos >> 4)[:, None]
            w = jnp.where(widx == wi, words, 0).sum(axis=1, dtype=jnp.uint32)
            return ((w >> ((pos.astype(jnp.uint32) & 15) * 2)) & 3
                    ).astype(jnp.int32)

        return _seed_scan3(fm3, codes_fn, jnp.asarray(rlens), BG, MAXLEN,
                           max_seeds)

    want = jax.device_get(ref_scan(fm3, jnp.asarray(packed), rlens))
    for gi, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(np.asarray(g), np.asarray(w)), gi
    assert int(np.asarray(want[0]).sum()) > BG // 2   # seeds actually found


def test_sharded_sa_resolve():
    """Sampled-SA walk with occ rows AND the sampled SA sharded over the
    mesh, every inverse-Psi step routed through collectives — positions
    must equal the host sa_lookup oracle."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mapcaller.index.fmindex import build_index
    from mapcaller.index.packer import PackedReference
    from mapcaller.ops.fm_device import DeviceFMIndex
    from mapcaller.parallel.mesh import make_mesh
    from mapcaller.parallel.sharded_index import build_sharded_sa_resolve

    rng = np.random.default_rng(29)
    L = 9000
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    ref = PackedReference(["chr1"], [L], [0], codes, [])
    idx = build_index(None, packed=ref)
    fm = DeviceFMIndex.from_host(idx)
    n_dev = 8
    mesh = make_mesh(n_dev)
    BG = 16 * n_dev
    rows = np.asarray(fm.occ_rows)
    rps = -(-rows.shape[0] // n_dev)
    occ_pad = np.zeros((n_dev * rps, 8), dtype=np.int32)
    occ_pad[:rows.shape[0]] = rows
    samp = np.asarray(fm.sa_samp)
    sps = -(-samp.shape[0] // n_dev)
    sa_pad = np.zeros((n_dev * sps,), dtype=np.int32)
    sa_pad[:samp.shape[0]] = samp

    ks = rng.integers(1, idx.seq_len, size=BG).astype(np.int32)
    fn = build_sharded_sa_resolve(fm, mesh, n_dev, 16)
    occ_s = jax.device_put(jnp.asarray(occ_pad.reshape(n_dev, rps, 8)),
                           NamedSharding(mesh, P("dp", None, None)))
    sa_s = jax.device_put(jnp.asarray(sa_pad.reshape(n_dev, sps)),
                          NamedSharding(mesh, P("dp", None)))
    k_s = jax.device_put(jnp.asarray(ks), NamedSharding(mesh, P("dp")))
    act = jax.device_put(jnp.ones(BG, bool), NamedSharding(mesh, P("dp")))
    loc, resolved = jax.device_get(fn(occ_s, sa_s, k_s, act))
    res = np.asarray(resolved)
    # the bounded walk resolves all but a geometric tail (production
    # flags those lanes for the host-oracle fallback, fm_device.py)
    assert res.sum() >= int(0.95 * BG), res.sum()
    for i, k in enumerate(ks):
        if res[i]:
            assert int(loc[i]) == idx.sa_lookup(int(k)), (i, k)


def test_sharded_production_chain_parity():
    """cfg.index_shards=8: the PRODUCTION backend's chain stage runs
    with the occ3 table genome-sharded over the mesh (routed gathers) —
    submit_chain/collect_chain outputs must be bit-identical to the
    single-chip kernel (the human-scale index path in the real
    backend, not just the dryrun)."""
    import numpy as np

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
    for shards in (0, 8):
        cfg = Config(sam_file="x", vcf_file="v", log_file="l",
                     index_shards=shards)
        be = DeviceBackend(idx, cfg)
        token = be.submit_chain(packed, rlens, bucket)
        outs.append(be.collect_chain(token, B,
                                     lambda i: mat[i, :100]))
    for a, b, name in zip(outs[0], outs[1],
                          ("cls", "pd", "mm", "rplast", "cscore", "counts",
                           "rpos", "gpos", "slen")):
        assert np.array_equal(np.asarray(a), np.asarray(b)), name
    assert (np.asarray(outs[0][5]) > 0).any()  # slow hits present


def test_sharded_backend_stream_golden(tmp_path, toy_fasta):
    """Full production stream (CLI semantics) with index_shards=8:
    paired-end subset must match the reference binary's golden SAM+VCF
    through the genome-sharded index path, including the device
    evidence planes fed from the sharded kernel's outputs."""
    import os
    import time

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
                 log_file=str(tmp_path / "s.log"), index_shards=8)
    backend = DeviceBackend(idx, cfg)
    engine = MappingEngine(idx, cfg, backend=backend)
    cfg.read_files1 = [os.path.join(data, "sub_r1.fq.gz")]
    cfg.read_files2 = [os.path.join(data, "sub_r2.fq.gz")]
    parts = []
    run_stream_mapping(engine, cfg, time.time(), parts.append)
    # the a920c8b escape class: grouped/sliced submits silently building
    # single-chip kernels under -shards stays byte-identical on this
    # shared-RAM CPU mesh, so the parity checks below cannot catch it —
    # assert the sharded kernels actually executed
    assert backend.sharded_invocations > 0
    engine.finalize()
    run_calling(engine, cfg, "t")

    import gzip
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


def test_sharded_chain_sampled_sa_walk():
    """Force the sampled-SA policy (no full SA in HBM): the sharded
    chain kernel's ROUTED inverse-Psi walk over sharded 1-step occ rows
    + SA samples must match the single-chip kernel's replicated walk
    bit-for-bit, including unresolved-row overflow flags."""
    import dataclasses as dc

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mapcaller.index.fmindex import build_index
    from mapcaller.index.packer import PackedReference
    from mapcaller.ops.fm3_device import DeviceFM3
    from mapcaller.ops.fm_search import build_seed_chain_kernel
    from mapcaller.parallel.mesh import make_mesh
    from mapcaller.parallel.sharded_index import (
        build_sharded_chain_kernel, shard_occ3_rows)

    rng = np.random.default_rng(43)
    codes = rng.integers(0, 4, size=24000).astype(np.uint8)
    idx = build_index(None, packed=PackedReference(
        ["chr1"], [len(codes)], [0], codes, []))
    fm3 = DeviceFM3.from_host(idx)
    fm_s = dc.replace(fm3.fm, sa_full=jnp.zeros(0, jnp.int32))
    fm3_s = dc.replace(fm3, fm=fm_s)
    from mapcaller.ops.chain_device import ChainCtx
    ctx = ChainCtx.from_host(idx)

    n_dev, B, bucket = 8, 128, 128
    mat = np.zeros((B, bucket), np.uint8)
    rlens = np.full(B, 100, np.int32)
    for i in range(B):
        p = int(rng.integers(0, len(codes) - 100))
        r = codes[p:p + 100].copy()
        if i % 4 == 1:
            r[25] = (r[25] + 1) % 4
        mat[i, :100] = r
    packed = np.zeros((B, bucket // 4), dtype=np.uint8)
    for j in range(4):
        packed |= (mat[:, j::4] & 3) << (2 * j)

    single = build_seed_chain_kernel(fm3_s, ctx, bucket, B)
    dev, _, _ = single(jnp.asarray(packed), jnp.asarray(rlens))
    (cls0, pd0, mm0, rpl0, csc0, cnt0, rp0, gp0, ln0, ovf0,
     buf0) = single.collect(dev)

    mesh = make_mesh(n_dev)

    def pad_split(a):
        a = np.asarray(a)
        per = -(-a.shape[0] // n_dev)
        pad = np.zeros((n_dev * per,) + a.shape[1:], dtype=a.dtype)
        pad[:a.shape[0]] = a
        return pad.reshape((n_dev, per) + a.shape[1:])

    occ3_s, _ = shard_occ3_rows(fm3_s, n_dev)
    fn = build_sharded_chain_kernel(fm3_s, ctx, mesh, n_dev, bucket, B)
    sh3 = NamedSharding(mesh, P("dp", None, None))
    sh2 = NamedSharding(mesh, P("dp", None))
    outs = fn(jax.device_put(jnp.asarray(occ3_s), sh3),
              jax.device_put(jnp.asarray(pad_split(fm_s.occ_rows)), sh3),
              jax.device_put(jnp.asarray(pad_split(fm_s.sa_samp)), sh2),
              jax.device_put(jnp.asarray(packed), sh2),
              jax.device_put(jnp.asarray(rlens),
                             NamedSharding(mesh, P("dp"))))
    (cls, pd, mm, rpl, csc, mmp, ovf, hit_read, hit_rpos, hit_len,
     hit_loc, keep_slow, buf) = [np.asarray(x) for x in outs]
    k = keep_slow.astype(bool)
    counts = np.bincount(hit_read[k], minlength=B)[:B].astype(np.int32)
    order = np.argsort(hit_read[k], kind="stable")
    assert np.array_equal(cls, cls0)
    assert np.array_equal(pd, pd0)
    assert np.array_equal(mm, mm0)
    assert np.array_equal(rpl, rpl0)
    assert np.array_equal(csc, csc0)
    assert np.array_equal(counts, cnt0)
    assert np.array_equal(hit_rpos[k][order], rp0)
    assert np.array_equal(hit_loc[k][order].astype(np.int64), gp0)
    assert np.array_equal(hit_len[k][order], ln0)
    assert np.array_equal(ovf.astype(bool), ovf0)


def test_sharded_tier_rerun_parity():
    """Hit-buffer overflow on the sharded path: the rerun hook must
    rebuild the sharded kernel at the larger tier (not the single-chip
    one) and outputs must match the plain backend's rerun results."""
    import numpy as np

    from mapcaller.config import Config
    from mapcaller.index.fmindex import build_index
    from mapcaller.index.packer import PackedReference
    from mapcaller.pipeline.device_backend import DeviceBackend

    rng = np.random.default_rng(47)
    unit = rng.integers(0, 4, 400).astype(np.uint8)
    genome = np.concatenate([rng.integers(0, 4, 3000).astype(np.uint8),
                             unit, unit, unit, unit,
                             rng.integers(0, 4, 3000).astype(np.uint8)])
    idx = build_index(None, packed=PackedReference(
        ["chr1"], [len(genome)], [0], genome, []))
    B, bucket = 256, 128
    mat = np.zeros((B, bucket), np.uint8)
    rlens = np.full(B, 100, np.int32)
    for i in range(B):
        p = int(rng.integers(3000, 3000 + 4 * 400 - 100))
        mat[i, :100] = genome[p:p + 100]
    packed = np.zeros((B, bucket // 4), dtype=np.uint8)
    for j in range(4):
        packed |= (mat[:, j::4] & 3) << (2 * j)

    outs = []
    for shards in (0, 8):
        cfg = Config(sam_file="x", vcf_file="v", log_file="l",
                     index_shards=shards)
        be = DeviceBackend(idx, cfg)
        token = be.submit_chain(packed, rlens, bucket)
        outs.append(be.collect_chain(token, B, lambda i: mat[i, :100]))
        assert be.n_tier_reruns >= 1 or be.n_full_fallbacks >= 1
    for a, b, name in zip(outs[0], outs[1],
                          ("cls", "pd", "mm", "rplast", "cscore", "counts",
                           "rpos", "gpos", "slen")):
        assert np.array_equal(np.asarray(a), np.asarray(b)), name


def test_sharded_backend_gvcf_parity(tmp_path, toy_fasta):
    """index_shards=8 x -gvcf: NOR blocks computed from device planes
    that were fed by the sharded kernel's outputs must equal the plain
    backend's gVCF byte-for-byte."""
    import os
    import time

    from mapcaller.config import Config
    from mapcaller.index.fmindex import build_index
    from mapcaller.pipeline.device_backend import DeviceBackend
    from mapcaller.pipeline.engine import MappingEngine
    from mapcaller.pipeline.stream import run_stream_mapping
    from mapcaller.runner import run_calling

    idx = build_index(toy_fasta)
    data = os.path.join(os.path.dirname(__file__), "data", "subset")
    vcfs = []
    for shards in (0, 8):
        cfg = Config(sam_file="x", vcf_file=str(tmp_path / f"{shards}.vcf"),
                     log_file=str(tmp_path / f"{shards}.log"),
                     gvcf=True, index_shards=shards)
        backend = DeviceBackend(idx, cfg)
        engine = MappingEngine(idx, cfg, backend=backend)
        cfg.read_files1 = [os.path.join(data, "sub_r1.fq.gz")]
        cfg.read_files2 = [os.path.join(data, "sub_r2.fq.gz")]
        parts = []
        run_stream_mapping(engine, cfg, time.time(), parts.append)
        engine.finalize()
        run_calling(engine, cfg, "t")
        vcfs.append([l for l in open(cfg.vcf_file)
                     if not l.startswith("##")])
    assert vcfs[0] == vcfs[1] and len(vcfs[0]) > 100
