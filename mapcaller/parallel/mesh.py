"""Multi-chip mapping + calling over a jax.sharding.Mesh — the
production pipeline's device stages, sharded.

The reference is single-node pthreads with four mutexes
(ref: src/main.cpp:27, SURVEY section 2c); the device-mesh equivalent:

  * the FM-index (3-step occ table) + text words replicated into every
    chip's HBM,
  * read batches sharded over the 'dp' mesh axis; every device runs the
    PRODUCTION seed -> chain -> classify stages (ops/fm_search
    _seed_scan3, ops/chain_device.classify_reads) on its shard,
  * fast-read evidence partials (exact-coverage endpoints, orientation
    ranges, mismatch point adds — pipeline/device_profile semantics)
    accumulate per device and reduce with psum over ICI,
  * the caller's dense scan (calling/scan_device semantics) runs
    GENOME-SHARDED: psum_scatter hands device i genome slice i, the
    coverage cumsum is stitched with an all_gather of shard totals, and
    gap/CNV run-length state is carried across slice boundaries by the
    host stitching pass (the reference hard-codes iThreadNum=1 for this
    scan precisely because of that seam, VariantCalling.cpp:717),
  * SLOW-class reads (multi-diagonal / indels / repeats) come back to
    the per-shard host exactly as in production and go through the
    host pipeline; their evidence merges as sparse deltas.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.chain_device import CLASS_FAST, CLASS_SLOW, ChainCtx, classify_reads
from ..ops.fm_device import DeviceFMIndex, sa_resolve
from ..ops.fm_search import MIN_SEED_LEN, _seed_scan, _seed_scan3


def make_mesh(n_devices: int) -> Mesh:
    devs = jax.devices()[:n_devices]
    if len(devs) < n_devices:
        raise RuntimeError(
            f"need {n_devices} devices, have {len(devs)} — set "
            "JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_"
            f"device_count={n_devices} for the virtual CPU mesh")
    return Mesh(np.array(devs), ("dp",))


def build_multichip_pipeline(fm, chain_ctx: ChainCtx, max_len: int,
                             per_device_batch: int, n_devices: int,
                             mesh: Mesh, hits_per_read: int = 8):
    """The production device pipeline, shard_mapped over 'dp'.

    Input:  packed 2-bit codes [B_global, max_len/4] sharded over dp,
            rlens [B_global] sharded over dp.
    Output (per call):
      cls [B_global]         read class (fast/slow/nocand), gathered
      pd, mm, mmp            fast-read evidence inputs, gathered
      hit data               slow reads' hits (for the host pipeline)
      acgt/exact/f partials  psum'd evidence planes (replicated)
      cov_shard [Gp/n]       genome-sharded coverage after the stitch
    """
    from ..ops.fm3_device import DeviceFM3
    use_occ3 = isinstance(fm, DeviceFM3)
    G = fm.genome_size if not use_occ3 else fm.fm.genome_size
    two_l = chain_ctx.seq_len
    L = two_l // 2
    B = per_device_batch
    max_seeds = max_len // (MIN_SEED_LEN + 1) + 2
    H = B * hits_per_read
    Gp = ((L + n_devices - 1) // n_devices) * n_devices

    def device_fn(packed, rlens):
        W4 = packed.shape[1]
        nwords = (W4 + 3) // 4
        pb = packed.astype(jnp.uint32).reshape(B, nwords, 4)
        sh8 = (jnp.arange(4, dtype=jnp.uint32) * 8)[None, None, :]
        words_le = (pb << sh8).sum(axis=2, dtype=jnp.uint32)
        widx = jnp.arange(nwords, dtype=jnp.int32)[None, :]

        def codes_fn(row, pos):
            wi = (pos >> 4)[:, None]
            w = jnp.where(widx == wi, words_le, 0).sum(axis=1,
                                                       dtype=jnp.uint32)
            return ((w >> ((pos.astype(jnp.uint32) & 15) * 2)) & 3
                    ).astype(jnp.int32)

        if use_occ3:
            (n_seeds, s_rpos, s_len, s_x0, s_freq, overflow) = _seed_scan3(
                fm, codes_fn, rlens, B, max_len, max_seeds)
            fm1 = fm.fm
        else:
            (n_seeds, s_rpos, s_len, s_x0, s_freq, overflow) = _seed_scan(
                fm, codes_fn, rlens, B, max_len, max_seeds, has_n=False)
            fm1 = fm

        sidx = jnp.arange(max_seeds, dtype=jnp.int32)[None, :]
        seed_valid = sidx < n_seeds[:, None]
        freqs = jnp.where(seed_valid, s_freq, 0).reshape(-1)
        x0s = s_x0.reshape(-1)
        rposs = s_rpos.reshape(-1)
        lens = s_len.reshape(-1)
        readix = jnp.repeat(jnp.arange(B, dtype=jnp.int32), max_seeds)
        total = freqs.sum()
        csum = jnp.cumsum(freqs) - freqs
        hpos = jnp.arange(H, dtype=jnp.int32)
        within = hpos - jnp.repeat(csum, freqs, total_repeat_length=H)
        hit_row = jnp.repeat(x0s, freqs, total_repeat_length=H) + within
        hit_rpos = jnp.repeat(rposs, freqs, total_repeat_length=H)
        hit_len = jnp.repeat(lens, freqs, total_repeat_length=H)
        hit_read = jnp.repeat(readix, freqs, total_repeat_length=H)
        hit_valid = hpos < jnp.minimum(total, H)
        hit_loc, resolved = sa_resolve(fm1, jnp.where(hit_valid, hit_row, 32),
                                       hit_valid)
        keep = hit_valid & ((hit_loc - hit_rpos) > 0)

        # production chaining/classification
        crumb = jnp.stack([(packed.astype(jnp.uint32) >> jnp.uint32(q * 2)) & 3
                           for q in range(4)], axis=-1).reshape(B, W4 * 4)
        cshift = jnp.asarray(((15 - (np.arange(max_len) & 15)) * 2)
                             .astype(np.uint32))
        cw = (crumb[:, :max_len] << cshift[None, :]).reshape(B, nwords, 16)
        words_bwa = cw.sum(axis=2, dtype=jnp.uint32)
        cls, pd0, mm, rplast, cscore, mmp = classify_reads(
            chain_ctx, words_bwa, rlens, hit_read, hit_rpos, hit_len,
            hit_loc, keep, max_len)

        # fast-read evidence partials (device_profile semantics; the
        # dup gate never binds on dryrun data — see module docstring)
        adm = cls == CLASS_FAST
        ori = pd0 < L
        g_start = jnp.clip(jnp.where(ori, pd0, two_l - pd0 - rlens), 0, L - 1)
        end = jnp.minimum(g_start + rlens, L)
        exact = jnp.zeros(L + 2, jnp.int32)
        dumpE = jnp.int32(L + 1)
        exact = exact.at[jnp.where(adm, g_start, dumpE)].add(
            jnp.where(adm, 1, 0), mode="drop")
        exact = exact.at[jnp.where(adm, end, dumpE)].add(
            jnp.where(adm, -1, 0), mode="drop")
        fpl = jnp.where(ori, 0, 3)   # single-end: b_first = True
        fd = jnp.zeros(4 * (L + 2), jnp.int32)
        dumpF = jnp.int32(4 * (L + 2) - 1)
        fd = fd.at[jnp.where(adm, fpl * (L + 2) + g_start, dumpF)].add(
            jnp.where(adm, 1, 0), mode="drop")
        fd = fd.at[jnp.where(adm, fpl * (L + 2) + end, dumpF)].add(
            jnp.where(adm, -1, 0), mode="drop")
        acgt = jnp.zeros(4 * (L + 1), jnp.int32)
        dumpA = jnp.int32(4 * (L + 1) - 1)
        for k in range(mmp.shape[1]):
            e = mmp[:, k]
            on = adm & (e >= 0)
            r = e >> 2
            base = e & 3
            p = jnp.clip(jnp.where(ori, pd0 + r, two_l - 1 - (pd0 + r)),
                         0, L - 1)
            exact = exact.at[jnp.where(on, p, dumpE)].add(
                jnp.where(on, -1, 0), mode="drop")
            exact = exact.at[jnp.where(on, p + 1, dumpE)].add(
                jnp.where(on, 1, 0), mode="drop")
            pb = jnp.where(ori, base, 3 - base)
            acgt = acgt.at[jnp.where(on, pb * (L + 1) + p, dumpA)].add(
                jnp.where(on, 1, 0), mode="drop")

        # genome-sharded coverage scan with cross-shard cumsum stitch:
        # psum_scatter sums the per-device diff partials AND hands
        # device i genome slice i in one collective
        diff_pad = jnp.zeros(Gp, jnp.int32).at[:L].set(exact[:L])
        diff_shard = jax.lax.psum_scatter(
            diff_pad.reshape(n_devices, -1), "dp", scatter_dimension=0,
            tiled=False)

        # evidence reduction over ICI: psum partials (replicated out)
        exact = jax.lax.psum(exact, "dp")
        fd = jax.lax.psum(fd, "dp")
        acgt = jax.lax.psum(acgt, "dp")

        my = jax.lax.axis_index("dp")
        totals = jax.lax.all_gather(diff_shard.sum(), "dp")
        base_cov = jnp.where(jnp.arange(n_devices) < my, totals, 0).sum()
        cov_shard = base_cov + jnp.cumsum(diff_shard)

        # slow reads' hits go back to the host pipeline (per shard)
        slow_keep = keep & (cls[jnp.clip(hit_read, 0, B - 1)] == CLASS_SLOW)
        return (cls, pd0, mm, rplast, cscore, mmp, hit_read, hit_rpos,
                hit_len, hit_loc, slow_keep, exact, fd.reshape(4, L + 2),
                acgt.reshape(4, L + 1), cov_shard)

    fn = jax.jit(
        jax.shard_map(device_fn, mesh=mesh,
                      in_specs=(P("dp", None), P("dp")),
                      out_specs=(P("dp"), P("dp"), P("dp"), P("dp"),
                                 P("dp"), P("dp", None),
                                 P("dp"), P("dp"), P("dp"), P("dp"),
                                 P("dp"), P(), P(), P(), P("dp"))))
    return fn


def build_multichip_evidence(chain_ctx: ChainCtx, per_device_batch: int,
                             n_devices: int, mesh: Mesh, pair_end: bool,
                             mm_slots: int = 4):
    """Phase-B evidence over the mesh, mirroring production: the host
    decides admission (unique-mapped + dup gate, pipeline semantics) and
    sends back a bitmask; the device builds fast-read evidence partials
    from its resident chain outputs and psums them over ICI.

    jit fn(pd [BG], mmp [BG, mm_slots], rlens [BG], fast_bits
    [BG/32 words per shard -> n*ceil(B/32)]) ->
    (exact_diff [L+2], f_diff [4, L+2], acgt [4, L+1]) replicated."""
    two_l = chain_ctx.seq_len
    L = two_l // 2
    B = per_device_batch

    def device_fn(pd0, mmp, rlens, fbits):
        pd0, mmp, rlens, fbits = pd0, mmp, rlens, fbits[0]
        bidx = jnp.arange(B, dtype=jnp.int32)
        adm = ((fbits[bidx >> 5] >> (bidx & 31)) & 1) == 1
        ori = pd0 < L
        g_start = jnp.clip(jnp.where(ori, pd0, two_l - pd0 - rlens), 0, L - 1)
        end = jnp.minimum(g_start + rlens, L)
        exact = jnp.zeros(L + 2, jnp.int32)
        dumpE = jnp.int32(L + 1)
        exact = exact.at[jnp.where(adm, g_start, dumpE)].add(
            jnp.where(adm, 1, 0), mode="drop")
        exact = exact.at[jnp.where(adm, end, dumpE)].add(
            jnp.where(adm, -1, 0), mode="drop")
        if pair_end:
            b_first = (bidx & 1) == 0
        else:
            b_first = jnp.ones(B, bool)
        fpl = jnp.where(b_first, jnp.where(ori, 0, 3),
                        jnp.where(ori, 1, 2)).astype(jnp.int32)
        fd = jnp.zeros(4 * (L + 2), jnp.int32)
        dumpF = jnp.int32(4 * (L + 2) - 1)
        fd = fd.at[jnp.where(adm, fpl * (L + 2) + g_start, dumpF)].add(
            jnp.where(adm, 1, 0), mode="drop")
        fd = fd.at[jnp.where(adm, fpl * (L + 2) + end, dumpF)].add(
            jnp.where(adm, -1, 0), mode="drop")
        acgt = jnp.zeros(4 * (L + 1), jnp.int32)
        dumpA = jnp.int32(4 * (L + 1) - 1)
        for k in range(mmp.shape[1]):
            e = mmp[:, k]
            on = adm & (e >= 0)
            r = e >> 2
            base = e & 3
            p = jnp.clip(jnp.where(ori, pd0 + r, two_l - 1 - (pd0 + r)),
                         0, L - 1)
            exact = exact.at[jnp.where(on, p, dumpE)].add(
                jnp.where(on, -1, 0), mode="drop")
            exact = exact.at[jnp.where(on, p + 1, dumpE)].add(
                jnp.where(on, 1, 0), mode="drop")
            pb = jnp.where(ori, base, 3 - base)
            acgt = acgt.at[jnp.where(on, pb * (L + 1) + p, dumpA)].add(
                jnp.where(on, 1, 0), mode="drop")
        exact = jax.lax.psum(exact, "dp")
        fd = jax.lax.psum(fd, "dp")
        acgt = jax.lax.psum(acgt, "dp")
        return exact, fd.reshape(4, L + 2), acgt.reshape(4, L + 1)

    fn = jax.jit(
        jax.shard_map(device_fn, mesh=mesh,
                      in_specs=(P("dp"), P("dp", None), P("dp"),
                                P("dp", None)),
                      out_specs=(P(), P(), P())))
    return fn


def run_mesh_pe_pipeline(idx, cfg, mat: np.ndarray, rlens: np.ndarray,
                         n_total: int, n_devices: int, max_len: int = 80,
                         mesh: Mesh | None = None):
    """Mesh-orchestrated paired-end mapping + calling with the
    PRODUCTION C++ host path per shard (the admit-bitmask round trip):

      phase A  classify every read on the mesh (seed -> chain ->
               classify, replicated index, reads sharded over 'dp'),
      host     each shard's C++ pipeline (ops mode) runs pairing /
               rescue / slow alignment / SAM semantics and decides
               admission (unique-mapped + PCR-dup gate); admit bitmasks
               come back per shard,
      phase B  fast-read evidence partials build on the mesh from the
               bitmasks and psum over ICI,
      merge    device planes + per-shard host diff arrays + sparse
               indel maps reduce (cap-after-sum), then the caller runs
               once over the merged evidence.

    Reads must be laid out shard-major in `mat` (pairs co-located on a
    shard — mirrors ReadMapping.cpp:627-643 thread-local merge). Note
    the per-shard dup gates: unlike `-devices N`
    (parallel/devices.py, globally-ordered gate), up to
    n_devices * max_duplicate same-start reads can be admitted on
    duplicate-heavy data (parallel/distributed.py documents the same
    contract). Returns (variants, merged_engine, shard_engines).

    This is the single-host form of the multi-host deployment
    (parallel/multihost.py): one process standing in for n hosts."""
    import jax
    from jax.sharding import NamedSharding
    from ..calling.caller import cal_block_read_depth, identify_variants
    from ..dna import decode
    from ..ops.fm3_device import DeviceFM3
    from ..pipeline.engine import MappingEngine
    from ..pipeline.profile import MAX_ALLELE_COUNT

    L = idx.genome_size
    fm3 = DeviceFM3.from_host(idx)
    ctx = ChainCtx.from_host(idx)
    if mesh is None:
        mesh = make_mesh(n_devices)
    BG = mat.shape[0]
    assert BG % n_devices == 0
    B = BG // n_devices

    packed = np.zeros((BG, max_len // 4), dtype=np.uint8)
    for j in range(4):
        packed |= (mat[:, j::4][:, :max_len // 4] & 3) << (2 * j)
    stepA = build_multichip_pipeline(fm3, ctx, max_len, B, n_devices, mesh)
    packed_s = jax.device_put(jnp.asarray(packed),
                              NamedSharding(mesh, P("dp", None)))
    rlens_s = jax.device_put(jnp.asarray(rlens),
                             NamedSharding(mesh, P("dp")))
    (cls, pd0, mm, rplast, cscore, mmp, hit_read, hit_rpos, hit_len,
     hit_loc, slow_keep, _ex, _fd, _ac, _cov) = stepA(packed_s, rlens_s)
    cls = np.asarray(cls)
    pd0_h = np.asarray(pd0)
    mm_h = np.asarray(mm)
    rplast = np.asarray(rplast)
    cscore = np.asarray(cscore)
    hit_read = np.asarray(hit_read)
    hit_rpos = np.asarray(hit_rpos)
    hit_len = np.asarray(hit_len)
    hit_loc = np.asarray(hit_loc)
    slow_keep = np.asarray(slow_keep)
    H = hit_read.shape[0] // n_devices

    # per-shard host pipeline (production C++ in ops mode)
    shard_bits = np.zeros((n_devices, (B + 31) // 32), dtype=np.int32)
    shard_engines = []
    for d in range(n_devices):
        eng = MappingEngine(idx, cfg, backend=None, use_native=True)
        eng.enable_diff_profile()
        eng.native.set_ops_mode(True)
        lo = d * B
        n_here = min(B, max(0, n_total - lo))
        fq = []
        for i in range(lo, lo + n_here):
            fq.append(f"@r{i}\n{decode(mat[i, :rlens[i]])}\n+\n"
                      f"{'I' * int(rlens[i])}\n")
        eng.native.set_input("".join(fq).encode(), None, False)
        nn, _ = eng.native.next_batch(0, B)
        assert nn == n_here
        # seeds for slow reads of this shard, grouped by read
        seg = slice(d * H, (d + 1) * H)
        keep = slow_keep[seg]
        gread = hit_read[seg]
        counts = np.bincount(gread[keep], minlength=B)[:B].astype(np.int32)
        ordd = np.argsort(gread[keep], kind="stable")
        rp = hit_rpos[seg][keep][ordd].astype(np.int32)
        gp = hit_loc[seg][keep][ordd].astype(np.int64)
        ln = hit_len[seg][keep][ordd].astype(np.int32)
        counts[n_here:] = 0
        stats_io = np.zeros(6, dtype=np.int64)
        stats_io[5] = 1000
        sl = slice(lo, lo + B)
        eng.native.process_batch_cls(
            0, True, True, cls[sl], pd0_h[sl], mm_h[sl], rplast[sl],
            cscore[sl], counts, rp, gp, ln, stats_io)
        shard_bits[d, :][:] = 0
        fb = eng.native.fetch_fast_bits()
        shard_bits[d, :fb.size] = fb.view(np.int32)
        shard_engines.append(eng)

    # phase B: mesh evidence from the admit bitmasks
    stepB = build_multichip_evidence(ctx, B, n_devices, mesh, pair_end=True,
                                     mm_slots=mmp.shape[1])
    pd_s = jax.device_put(pd0, NamedSharding(mesh, P("dp")))
    mmp_s = jax.device_put(mmp, NamedSharding(mesh, P("dp", None)))
    fb_s = jax.device_put(jnp.asarray(shard_bits),
                          NamedSharding(mesh, P("dp", None)))
    exact, fd, acgt_dev = jax.device_get(stepB(pd_s, mmp_s, rlens_s, fb_s))

    # merge device planes + per-shard host diffs (cap-after-sum)
    ref_codes = idx.ref.ref_sequence_codes()
    exact_d = exact[:L + 1].astype(np.int64)
    fd_d = fd[:, :L + 1].astype(np.int64)
    acgt = acgt_dev[:, :L].astype(np.int64)
    multi_d = np.zeros(L + 1, dtype=np.int64)
    for eng in shard_engines:
        p = eng.profile
        exact_d += p.exact_diff
        multi_d += p.multi_diff
        for k, nm in enumerate(("F1_diff", "R2_diff", "F2_diff", "R1_diff")):
            fd_d[k] += getattr(p, nm)
        acgt += p.acgt
    exact_cov = np.cumsum(exact_d[:L])
    for c in range(4):
        acgt[c] += np.where(ref_codes[:L] == c, exact_cov, 0)
    np.minimum(acgt, MAX_ALLELE_COUNT, out=acgt)
    F = np.cumsum(fd_d[:, :L], axis=1)

    merged = MappingEngine(idx, cfg, backend=None, use_native=False)
    merged.profile.acgt = acgt.astype(np.int32)
    merged.profile.multi_hit[:] = np.minimum(
        np.cumsum(multi_d[:L]), MAX_ALLELE_COUNT).astype(np.int32)
    for nm, k in (("F1", 0), ("R2", 1), ("F2", 2), ("R1", 3)):
        getattr(merged.profile, nm)[:] = F[k].astype(np.int32)
    for eng in shard_engines:
        for src, dst in ((eng.profile.insert_map, merged.profile.insert_map),
                         (eng.profile.delete_map, merged.profile.delete_map)):
            for posk, inner in src.items():
                dd = dst.setdefault(posk, {})
                for seq, cnt in inner.items():
                    dd[seq] = dd.get(seq, 0) + cnt
    bd = cal_block_read_depth(merged.profile, L)
    variants = identify_variants(cfg, merged.genome, merged.profile,
                                 ref_codes, bd)
    return variants, merged, shard_engines


# kept for backward compatibility with the coverage-only smoke test
def build_multichip_map_step(fm: DeviceFMIndex, max_len: int,
                             per_device_batch: int, n_devices: int,
                             mesh: Mesh, hits_per_read: int = 8):
    """Seeding + exact-coverage reduction only (round-1 step; superseded
    by build_multichip_pipeline)."""
    G = fm.genome_size
    max_seeds = max_len // (MIN_SEED_LEN + 1) + 2
    B = per_device_batch
    H = B * hits_per_read
    G_pad = ((G + n_devices - 1) // n_devices) * n_devices

    from ..ops.fm_search import crumb_lookup

    def device_fn(packed, rlens):
        codes_fn = lambda row, pos: crumb_lookup(packed, row, pos)
        (n_seeds, s_rpos, s_len, s_x0, s_freq, overflow) = _seed_scan(
            fm, codes_fn, rlens, B, max_len, max_seeds, has_n=False)
        sidx = jnp.arange(max_seeds, dtype=jnp.int32)[None, :]
        seed_valid = sidx < n_seeds[:, None]
        freqs = jnp.where(seed_valid, s_freq, 0).reshape(-1)
        x0s = s_x0.reshape(-1)
        lens = s_len.reshape(-1)
        total = freqs.sum()
        csum = jnp.cumsum(freqs) - freqs
        hpos = jnp.arange(H, dtype=jnp.int32)
        within = hpos - jnp.repeat(csum, freqs, total_repeat_length=H)
        hit_row = jnp.repeat(x0s, freqs, total_repeat_length=H) + within
        hit_len = jnp.repeat(lens, freqs, total_repeat_length=H)
        hit_valid = hpos < jnp.minimum(total, H)
        hit_loc, resolved = sa_resolve(fm, jnp.where(hit_valid, hit_row, 32),
                                       hit_valid)
        ok = hit_valid & resolved & (hit_loc < G)
        start = jnp.where(ok, hit_loc, G_pad)
        end = jnp.where(ok, jnp.minimum(hit_loc + hit_len, G), G_pad)
        diff = (jnp.zeros(G_pad + 1, dtype=jnp.int32)
                .at[start].add(1).at[end].add(-1))[:G_pad]
        diff_shard = jax.lax.psum_scatter(diff.reshape(n_devices, -1),
                                          "dp", scatter_dimension=0,
                                          tiled=False)
        my = jax.lax.axis_index("dp")
        totals = jax.lax.all_gather(diff_shard.sum(), "dp")
        base = jnp.where(jnp.arange(n_devices) < my, totals, 0).sum()
        cov_shard = base + jnp.cumsum(diff_shard)
        return cov_shard, jax.lax.psum(ok.sum(), "dp")

    fn = jax.jit(
        jax.shard_map(device_fn, mesh=mesh,
                      in_specs=(P("dp", None), P("dp")),
                      out_specs=(P("dp"), P()))
    )
    return fn
