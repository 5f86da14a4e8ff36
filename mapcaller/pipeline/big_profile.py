"""Genome-sharded evidence planes for human-scale genomes.

The single-chip DeviceEvidence keeps ~16 B/base of dense per-position
state (acgt + exact/orientation/multi diff planes) in one device's HBM;
at 3 Gbp that is ~50 GB — more than any one chip holds.  Here every
plane is sharded over the 'dp' mesh axis (the same mesh the big-genome
x64 chain kernels run on, parallel/big_index.py), and every stage that
touched a dense plane runs as a shard_map kernel over the LOCAL slice:

  apply      scatter-adds of a batch's fast-read evidence — the batch
             arrays (B ints) are all_gathered (tiny), each shard
             scatters the endpoints that land in its genome slice
  merge      the host profile's sparse slow-read deltas, same routing
  finalize   per-shard cumsums of the diff planes with the carry
             stitched by an all_gather of shard totals (the seam
             pattern proven in parallel/mesh.py)
  scan       the caller's dense scan per shard; run-length state is
             carried across seams with one boundary exchange, sparse
             candidates/runs come back per shard and are concatenated
             in shard order on the host — bit-identical to the global
             kernel including the CAND_CAP/RUN_CAP truncation order
  fetch/NOR  replicated sparse queries, each shard answers what it
             owns, combined with psum / pmin

No L-sized array ever materializes on a single device; per-device
memory is O(L/n).  Reference behavior matched: the uint64 index types
(src/BWT_Index/bwt.h:44) mean the reference maps+calls human genomes in
one address space; this is the device-mesh equivalent at human scale.
Positions are int64 throughout (global genome coordinates exceed 2^31
on human fwd texts); local slice offsets fit int32.

Plane layout: padded stride P = n * Pl with Pl a multiple of 400
(lcm(BLOCK_SIZE=100, 16 bases/text-word) so caller blocks and text
words never straddle a shard seam), P >= L + 2.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..calling.scan_device import BLK_PART, BLOCK_SIZE, CAND_CAP, RUN_CAP
from .device_profile import MAX_ALLELE_COUNT, DeviceEvidence, DevicePlanes

_GRAN = 400   # lcm(BLOCK_SIZE, 16)


def _x64(fn):
    def wrap(*a, **k):
        with jax.enable_x64(True):
            return fn(*a, **k)
    return wrap


class BigDeviceEvidence(DeviceEvidence):
    """DeviceEvidence with genome-sharded planes (see module docstring).
    Public contract (apply_batch / reconcile_batch / scan /
    fetch_columns / nor_blocks / download_raw_into) is unchanged."""

    def __init__(self, backend, cfg, host_profile):
        self.be = backend
        self.cfg = cfg
        self.host_profile = host_profile
        self.L = backend.idx.genome_size
        self.two_l = backend.idx.seq_len
        self.n = backend.index_shards
        self.mesh = backend._big_setup()[0]
        self.Pl = -(-(self.L + 2) // (self.n * _GRAN)) * _GRAN
        self.Pg = self.n * self.Pl
        self._kern = {}
        self._final = None
        self._scan = None
        self._scan_pending = None
        with jax.enable_x64(True):
            self.planes = DevicePlanes(
                acgt=self._put(jnp.zeros((4, self.Pg), jnp.int32),
                               P(None, "dp")),
                exact_diff=self._put(jnp.zeros(self.Pg, jnp.int32),
                                     P("dp")),
                f_diff=self._put(jnp.zeros((4, self.Pg), jnp.int32),
                                 P(None, "dp")),
                multi_diff=self._put(jnp.zeros(self.Pg, jnp.int32),
                                     P("dp")),
                L=self.L)
            # forward-genome text words, padded to the sharded stride so
            # each shard derives its ref-code slice locally (replicated,
            # ~0.25 B/base)
            ctx = backend.chain_ctx
            nw = self.Pg // 16
            w = np.zeros(nw, dtype=np.uint32)
            src = np.asarray(ctx.text_words)[:min(len(ctx.text_words), nw)]
            w[:src.size] = src.astype(np.uint32)
            self._words = self._put(jnp.asarray(w), P(None))

    def _put(self, a, spec):
        return jax.device_put(a, NamedSharding(self.mesh, spec))

    # ------------------------------------------------------------------
    # local scatter of one batch's fast-read evidence
    # ------------------------------------------------------------------
    def _apply_kernel(self, B: int, pair_end: bool):
        key = ("apply", B, pair_end)
        if key in self._kern:
            return self._kern[key]
        L, two_l, Pl, n = self.L, self.two_l, self.Pl, self.n

        def device_fn(acgt, exact, fd, multi, pd, mmp, rl, fbits):
            pd = jax.lax.all_gather(pd, "dp", tiled=True)
            mmp = jax.lax.all_gather(mmp, "dp", tiled=True)
            rl = jax.lax.all_gather(rl, "dp", tiled=True)
            my = jax.lax.axis_index("dp").astype(jnp.int64)
            off = my * Pl
            bidx = jnp.arange(B, dtype=jnp.int32)
            adm = ((fbits[bidx >> 5] >> (bidx & 31)) & 1) == 1
            if pair_end:
                b_first = (bidx & 1) == 0
            else:
                b_first = jnp.ones(B, bool)
            pd = pd.astype(jnp.int64)
            rl64 = rl.astype(jnp.int64)
            ori = pd < L
            g_start = jnp.clip(jnp.where(ori, pd, two_l - pd - rl64),
                               0, L - 1)
            end = jnp.minimum(g_start + rl64, L)

            def scat(plane, gidx, on, val):
                li = gidx - off
                ok = on & (li >= 0) & (li < Pl)
                li32 = jnp.clip(li, 0, Pl - 1).astype(jnp.int32)
                return plane.at[jnp.where(ok, li32, 0)].add(
                    jnp.where(ok, val, 0))

            def scat2(plane, prow, gidx, on, val):
                li = gidx - off
                ok = on & (li >= 0) & (li < Pl)
                li32 = jnp.clip(li, 0, Pl - 1).astype(jnp.int32)
                return plane.at[prow, jnp.where(ok, li32, 0)].add(
                    jnp.where(ok, val, 0))

            one = jnp.int32(1)
            exact = scat(exact, g_start, adm, one)
            exact = scat(exact, end, adm, -one)
            fpl = jnp.where(b_first, jnp.where(ori, 0, 3),
                            jnp.where(ori, 1, 2)).astype(jnp.int32)
            fd = scat2(fd, fpl, g_start, adm, one)
            fd = scat2(fd, fpl, end, adm, -one)
            for k in range(mmp.shape[1]):
                e = mmp[:, k].astype(jnp.int64)
                on = adm & (e >= 0)
                r = e >> 2
                base = (e & 3).astype(jnp.int32)
                p = jnp.clip(jnp.where(ori, pd + r, two_l - 1 - (pd + r)),
                             0, L - 1)
                exact = scat(exact, p, on, -one)
                exact = scat(exact, p + 1, on, one)
                pb = jnp.where(ori, base, 3 - base)
                acgt = scat2(acgt, pb, p, on, one)
            return acgt, exact, fd, multi

        fn = jax.jit(jax.shard_map(
            device_fn, mesh=self.mesh,
            in_specs=(P(None, "dp"), P("dp"), P(None, "dp"), P("dp"),
                      P("dp"), P("dp", None), P("dp"), P(None)),
            out_specs=(P(None, "dp"), P("dp"), P(None, "dp"), P("dp"))),
            donate_argnums=(0, 1, 2, 3))
        self._kern[key] = fn
        return fn

    @_x64
    def apply_batch(self, token, fast_bits: np.ndarray,
                    pair_end: bool) -> None:
        pd_dev, mmp_dev, rl_dev = token[6], token[7], token[8]
        B = int(rl_dev.shape[0])
        fb = np.zeros((B + 31) // 32, dtype=np.int32)
        fb[:fast_bits.size] = fast_bits.view(np.int32)
        fn = self._apply_kernel(B, bool(pair_end))
        p = self.planes
        acgt, exact, fd, multi = fn(p.acgt, p.exact_diff, p.f_diff,
                                    p.multi_diff, pd_dev, mmp_dev, rl_dev,
                                    self._put(jnp.asarray(fb), P(None)))
        self.planes = DevicePlanes(acgt=acgt, exact_diff=exact, f_diff=fd,
                                   multi_diff=multi, L=self.L)

    # ------------------------------------------------------------------
    # host slow-read deltas -> sharded planes (replicated sparse input)
    # ------------------------------------------------------------------
    def _merge_kernel(self, N: int):
        key = ("merge", N)
        if key in self._kern:
            return self._kern[key]
        Pl = self.Pl

        def device_fn(acgt, exact, fd, multi,
                      pa_, ga, va, na, ge, ve, ne,
                      pf_, gf, vf, nf, gm, vm, nm):
            my = jax.lax.axis_index("dp").astype(jnp.int64)
            off = my * Pl
            onN = jnp.arange(N, dtype=jnp.int32)

            def scat(plane, gidx, val, cnt):
                li = gidx - off
                ok = (onN < cnt) & (li >= 0) & (li < Pl)
                li32 = jnp.clip(li, 0, Pl - 1).astype(jnp.int32)
                return plane.at[jnp.where(ok, li32, 0)].add(
                    jnp.where(ok, val, 0))

            def scat2(plane, prow, gidx, val, cnt):
                li = gidx - off
                ok = (onN < cnt) & (li >= 0) & (li < Pl)
                li32 = jnp.clip(li, 0, Pl - 1).astype(jnp.int32)
                return plane.at[prow, jnp.where(ok, li32, 0)].add(
                    jnp.where(ok, val, 0))

            acgt = scat2(acgt, pa_, ga, va, na)
            exact = scat(exact, ge, ve, ne)
            fd = scat2(fd, pf_, gf, vf, nf)
            multi = scat(multi, gm, vm, nm)
            return acgt, exact, fd, multi

        rep = (P(None), P(None), P(None), P(),
               P(None), P(None), P(),
               P(None), P(None), P(None), P(),
               P(None), P(None), P())
        fn = jax.jit(jax.shard_map(
            device_fn, mesh=self.mesh,
            in_specs=(P(None, "dp"), P("dp"), P(None, "dp"), P("dp")) + rep,
            out_specs=(P(None, "dp"), P("dp"), P(None, "dp"), P("dp"))),
            donate_argnums=(0, 1, 2, 3))
        self._kern[key] = fn
        return fn

    @_x64
    def _merge_host_deltas(self) -> None:
        p = self.host_profile
        L = self.L
        if (hasattr(p, "any_host_evidence")
                and not p.any_host_evidence()):
            # no host-side evidence this run (all reads applied on
            # device): skip eight O(L) nonzero scans + a merge dispatch
            return

        def nz(arr):
            a = np.asarray(arr).reshape(-1)
            idx = np.nonzero(a)[0]
            return idx.astype(np.int64), a[idx].astype(np.int32)

        ia, va = nz(p.acgt)                       # host acgt is [4, L]
        pa_, ga = (ia // L).astype(np.int32), ia % L
        ie, ve = nz(p.exact_diff)
        fparts = [nz(getattr(p, nm)) for nm in ("F1_diff", "R2_diff",
                                                "F2_diff", "R1_diff")]
        pf_ = np.concatenate([np.full(i.size, k, np.int32)
                              for k, (i, _) in enumerate(fparts)])
        gf = np.concatenate([i for i, _ in fparts])
        vf = np.concatenate([v for _, v in fparts])
        im, vm = nz(p.multi_diff)
        n = max(ga.size, ie.size, gf.size, im.size, 1)
        N = next(t for t in self.MERGE_TIERS if t >= n)

        def pad(a, dtype):
            out = np.zeros(N, dtype=dtype)
            out[:a.size] = a
            return out

        rep = lambda a: self._put(jnp.asarray(a), P(None))
        fn = self._merge_kernel(N)
        pl = self.planes
        acgt, exact, fd, multi = fn(
            pl.acgt, pl.exact_diff, pl.f_diff, pl.multi_diff,
            rep(pad(pa_, np.int32)), rep(pad(ga, np.int64)),
            rep(pad(va, np.int32)), jnp.int32(ga.size),
            rep(pad(ie, np.int64)), rep(pad(ve, np.int32)),
            jnp.int32(ie.size),
            rep(pad(pf_, np.int32)), rep(pad(gf, np.int64)),
            rep(pad(vf, np.int32)), jnp.int32(gf.size),
            rep(pad(im, np.int64)), rep(pad(vm, np.int32)),
            jnp.int32(im.size))
        self.planes = DevicePlanes(acgt=acgt, exact_diff=exact, f_diff=fd,
                                   multi_diff=multi, L=self.L)
        p.acgt[:] = 0
        p.exact_diff[:] = 0
        for name in ("F1_diff", "R2_diff", "F2_diff", "R1_diff",
                     "multi_diff"):
            getattr(p, name)[:] = 0

    # ------------------------------------------------------------------
    # finalize: per-shard cumsums + carry stitch (mesh.py seam pattern)
    # ------------------------------------------------------------------
    def _finalize_kernel(self):
        key = ("finalize",)
        if key in self._kern:
            return self._kern[key]
        Pl, n, L = self.Pl, self.n, self.L

        def carry(csum_last):
            my = jax.lax.axis_index("dp")
            totals = jax.lax.all_gather(csum_last, "dp")     # [n, ...]
            return jnp.where((jnp.arange(n) < my)
                             .reshape((n,) + (1,) * (csum_last.ndim)),
                             totals, 0).sum(axis=0)

        def device_fn(acgt, exact, fd, multi, words):
            my = jax.lax.axis_index("dp").astype(jnp.int64)
            off = my * Pl
            # ref codes for this shard's slice from the replicated words
            w = jax.lax.dynamic_slice(
                words, ((my * (Pl // 16)).astype(jnp.int32),), (Pl // 16,))
            sh = jnp.asarray(((15 - (np.arange(16) & 15)) * 2)
                             .astype(np.uint32))
            rc = ((w[:, None] >> sh[None, :]) & 3).astype(
                jnp.int32).reshape(-1)

            ce = jnp.cumsum(exact, dtype=jnp.int32)
            ex_cum = ce + carry(ce[-1])
            acgt_f = acgt + (jnp.arange(4, dtype=jnp.int32)[:, None]
                             == rc[None, :]) * ex_cum[None, :]
            acgt_f = jnp.minimum(acgt_f, MAX_ALLELE_COUNT)
            cf = jnp.cumsum(fd, axis=1, dtype=jnp.int32)
            F = cf + carry(cf[:, -1])[:, None]
            cm = jnp.cumsum(multi, dtype=jnp.int32)
            mu = jnp.minimum(cm + carry(cm[-1]), MAX_ALLELE_COUNT)
            cov = acgt_f.sum(axis=0)
            # int64 local coverage prefix + the shard totals for global
            # prefix reconstruction (cov sums exceed int32 at scale)
            ccov = jnp.cumsum(cov.astype(jnp.int64))
            cov_tot = jax.lax.all_gather(ccov[-1], "dp")     # [n] repl.
            return acgt_f, F, mu, cov, ccov, cov_tot

        fn = jax.jit(jax.shard_map(
            device_fn, mesh=self.mesh,
            in_specs=(P(None, "dp"), P("dp"), P(None, "dp"), P("dp"),
                      P(None)),
            out_specs=(P(None, "dp"), P(None, "dp"), P("dp"), P("dp"),
                       P("dp"), P(None)),
            # cov_tot is an all_gather output (identical on every
            # shard); the static VMA check can't see that
            check_vma=False),
            # the diff planes are dead once folded — donating them lets
            # XLA reuse their ~40 GB for the finalize outputs instead
            # of doubling residency (the 1 Gbp calling phase OOM'd at
            # ~148 GB without this; any accidental later use of
            # self.planes raises a donated-buffer error, loudly)
            donate_argnums=(0, 1, 2, 3))
        self._kern[key] = fn
        return fn

    @_x64
    def finalize(self):
        """-> (acgt, F, multi, cov, ccov, cov_tot), all genome-sharded
        except cov_tot [n] (per-shard inclusive coverage totals)."""
        if self._final is None:
            self._merge_host_deltas()
            p = self.planes
            self._final = self._finalize_kernel()(
                p.acgt, p.exact_diff, p.f_diff, p.multi_diff, self._words)
        return self._final

    # ------------------------------------------------------------------
    # caller dense scan, per shard + host stitch
    # ------------------------------------------------------------------
    def _scan_kernel(self, somatic: bool):
        key = ("scan", somatic)
        if key in self._kern:
            return self._kern[key]
        Pl, n, L = self.Pl, self.n, self.L
        nbl = Pl // BLOCK_SIZE
        CAPC = CAND_CAP
        CAPR = RUN_CAP

        def device_fn(acgt, multi, cov, words, min_ad, freq_base):
            my = jax.lax.axis_index("dp").astype(jnp.int64)
            off = my * Pl
            pos = jnp.arange(Pl, dtype=jnp.int32)
            valid = (off + pos) < L
            w = jax.lax.dynamic_slice(
                words, ((my * (Pl // 16)).astype(jnp.int32),), (Pl // 16,))
            sh = jnp.asarray(((15 - (np.arange(16) & 15)) * 2)
                             .astype(np.uint32))
            rc = ((w[:, None] >> sh[None, :]) & 3).astype(
                jnp.int32).reshape(-1)

            covm = jnp.where(valid, cov, 0)
            sums = covm.reshape(nbl, BLOCK_SIZE).sum(axis=1)
            block_depth = jnp.where(sums > 0, sums // BLOCK_SIZE,
                                    0).astype(jnp.int32)
            ad = min_ad
            if somatic:
                cov_thr = jnp.full(Pl, ad, jnp.int32)
            else:
                bd_pos = jnp.repeat(block_depth, BLOCK_SIZE,
                                    total_repeat_length=Pl)
                cov_thr = jnp.maximum(bd_pos >> 1, ad)
            nonref_max = jnp.full(Pl, -1, jnp.int32)
            for c in range(4):
                nonref_max = jnp.maximum(
                    nonref_max, jnp.where(rc == c, -1, acgt[c]))
            sup_thr = jnp.maximum(
                (covm.astype(jnp.float32) * freq_base).astype(jnp.int32)
                - 1, ad)
            cand_mask = valid & (covm >= cov_thr) & (nonref_max >= sup_thr)
            dest = jnp.cumsum(cand_mask.astype(jnp.int32)) - 1
            n_cand = jnp.where(cand_mask, dest + 1, 0).max()
            cand_loc = jnp.full(CAPC + 1, -1, jnp.int32).at[
                jnp.where(cand_mask, jnp.minimum(dest, CAPC), CAPC)].set(
                pos, mode="drop")[:CAPC]

            state = jnp.where(covm > 0, 2,
                              jnp.where(valid & (multi > 0), 1, 0)
                              ).astype(jnp.int32)
            prev = jax.lax.ppermute(state[-1], "dp",
                                    [(i, i + 1) for i in range(n - 1)])
            first_new = jnp.where(my == 0, True, state[0] != prev)
            newrun = valid & jnp.concatenate(
                [first_new[None], state[1:] != state[:-1]])
            rdest = jnp.cumsum(newrun.astype(jnp.int32)) - 1
            n_runs = jnp.where(newrun, rdest + 1, 0).max()
            run_loc = jnp.full(CAPR + 1, -1, jnp.int32).at[
                jnp.where(newrun, jnp.minimum(rdest, CAPR), CAPR)].set(
                pos, mode="drop")[:CAPR]
            run_val = jnp.zeros(CAPR + 1, jnp.int32).at[
                jnp.where(newrun, jnp.minimum(rdest, CAPR), CAPR)].set(
                state, mode="drop")[:CAPR]

            aligned = covm > 0
            n_aligned = aligned.sum().astype(jnp.int64)
            blk_hi = jnp.where(aligned, covm >> 8, 0).reshape(
                nbl, BLOCK_SIZE).sum(axis=1).astype(jnp.int32)
            blk_lo = jnp.where(aligned, covm & 255, 0).reshape(
                nbl, BLOCK_SIZE).sum(axis=1).astype(jnp.int32)
            # shard-local BLK_PART partials (int32-safe, see scan_device)
            npart = (nbl + BLK_PART - 1) // BLK_PART
            padb = npart * BLK_PART - nbl
            hi_part = jnp.concatenate(
                [blk_hi, jnp.zeros(padb, jnp.int32)]).reshape(
                npart, BLK_PART).sum(axis=1)
            lo_part = jnp.concatenate(
                [blk_lo, jnp.zeros(padb, jnp.int32)]).reshape(
                npart, BLK_PART).sum(axis=1)
            return (block_depth, cand_loc[None], jnp.int32(n_cand)[None],
                    run_loc[None], run_val[None], jnp.int32(n_runs)[None],
                    n_aligned[None], hi_part, lo_part)

        fn = jax.jit(jax.shard_map(
            device_fn, mesh=self.mesh,
            in_specs=(P(None, "dp"), P("dp"), P("dp"), P(None), P(),
                      P()),
            out_specs=(P("dp"), P("dp", None), P("dp"), P("dp", None),
                       P("dp", None), P("dp"), P("dp"), P("dp"),
                       P("dp"))))
        self._kern[key] = fn
        return fn

    def start_scan(self):
        """No-op: the sharded scan below manages its own two-transfer
        collection over the mesh; the single-chip async pre-dispatch
        (DeviceEvidence.start_scan) does not apply to shard_map'd
        planes."""
        return

    @_x64
    def scan(self):
        if self._scan is not None:
            return self._scan
        acgt, F, multi, cov, ccov, cov_tot = self.finalize()
        freq_base = 0.01 if self.cfg.somatic else self.cfg.frequency_thr
        fn = self._scan_kernel(bool(self.cfg.somatic))
        (bd, cand_loc, n_cand_l, run_loc, run_val_l, n_runs_l,
         n_aligned_l, hi_part, lo_part) = fn(
            acgt, multi, cov, self._words,
            jnp.int32(self.cfg.min_allele_depth), jnp.float32(freq_base))
        n = self.n
        Pl = self.Pl
        nb = (self.L + BLOCK_SIZE - 1) // BLOCK_SIZE
        # TWO D2H round trips (per-transfer latency
        # dominates small pulls): packed per-shard counts + coverage
        # partials first, then one packed transfer of bucketed
        # per-shard prefixes of the cand/run tables (capacity-padded
        # they would be n x 8.5 MB for a few thousand entries)
        small = np.asarray(jnp.concatenate(
            [n_cand_l.astype(jnp.int64), n_runs_l.astype(jnp.int64),
             n_aligned_l.astype(jnp.int64), hi_part.astype(jnp.int64),
             lo_part.astype(jnp.int64)]))
        n_cand_l = small[:n]
        n_runs_l = small[n:2 * n]
        n_aligned = int(small[2 * n:3 * n].sum())
        total_cov = int((small[3 * n:3 * n + (small.size - 3 * n) // 2]
                         .sum() << 8)
                        + small[3 * n + (small.size - 3 * n) // 2:].sum())

        def _ksz(cnt, cap):
            k = 1024
            while k < cnt:
                k <<= 1
            return min(k, cap)
        k1 = [_ksz(int(n_cand_l[s]), CAND_CAP) for s in range(n)]
        k2 = [_ksz(int(n_runs_l[s]), RUN_CAP) for s in range(n)]
        packed = np.asarray(jnp.concatenate(
            [cand_loc[s, :k1[s]] for s in range(n)]
            + [a for s in range(n)
               for a in (run_loc[s, :k2[s]], run_val_l[s, :k2[s]])]))
        parts, off = [], 0
        for ln in (k1 + [k for s in range(n) for k in (k2[s], k2[s])]):
            parts.append(packed[off:off + ln])
            off += ln
        # shard-order concatenation == global position-order compaction
        cand = np.concatenate(
            [parts[s][:min(int(n_cand_l[s]), CAND_CAP)].astype(np.int64)
             + s * Pl for s in range(n)])
        runs = np.concatenate(
            [parts[n + 2 * s][:min(int(n_runs_l[s]), RUN_CAP)]
             .astype(np.int64) + s * Pl for s in range(n)])
        rvals = np.concatenate(
            [parts[n + 2 * s + 1][:min(int(n_runs_l[s]), RUN_CAP)]
             for s in range(n)])
        n_cand = int(n_cand_l.sum())
        n_runs = int(n_runs_l.sum())
        cand_idx = cand[:CAND_CAP]
        run_start = runs[:RUN_CAP]
        run_val = rvals[:RUN_CAP]
        scal4 = np.array([n_cand, n_runs, n_aligned, total_cov],
                         dtype=np.int64)
        from ..calling.scan_device import LazyBlockDepth
        self._scan = (LazyBlockDepth(bd, nb), cand_idx,
                      run_start, run_val, scal4)
        return self._scan

    # ------------------------------------------------------------------
    # sparse queries against the sharded finalize outputs
    # ------------------------------------------------------------------
    def _fetch_kernel(self, K: int, KP: int):
        key = ("fetch", K, KP)
        if key in self._kern:
            return self._kern[key]
        Pl, n, L = self.Pl, self.n, self.L

        def device_fn(acgt, multi, F, cov, ccov, cov_tot, positions,
                      prefix_pts):
            my = jax.lax.axis_index("dp").astype(jnp.int64)
            off = my * Pl
            p = jnp.clip(positions, 0, L - 1)
            li = p - off
            mine = (li >= 0) & (li < Pl)
            li32 = jnp.clip(li, 0, Pl - 1).astype(jnp.int32)
            cols = jnp.stack(
                [acgt[0][li32], acgt[1][li32], acgt[2][li32],
                 acgt[3][li32], multi[li32],
                 F[0][li32], F[1][li32], F[2][li32], F[3][li32],
                 cov[li32]], axis=1)
            cols = jnp.where(mine[:, None], cols, 0)
            cols = jax.lax.psum(cols, "dp")
            # global exclusive coverage prefix at prefix_pts (<= L):
            # shard base (inclusive totals of earlier shards) + local
            pp = jnp.clip(prefix_pts, 0, L)
            lip = pp - off
            minep = (lip >= 0) & (lip < Pl)
            base = jnp.where(jnp.arange(n) < my, cov_tot, 0).sum()
            lip32 = jnp.clip(lip - 1, 0, Pl - 1).astype(jnp.int32)
            local = jnp.where(lip == 0, 0, ccov[lip32])
            pref = jnp.where(minep, base + local, 0)
            pref = jax.lax.psum(pref, "dp")
            return cols, pref

        fn = jax.jit(jax.shard_map(
            device_fn, mesh=self.mesh,
            in_specs=(P(None, "dp"), P("dp"), P(None, "dp"), P("dp"),
                      P("dp"), P(None), P(None), P(None)),
            out_specs=(P(None), P(None))))
        self._kern[key] = fn
        return fn

    @_x64
    def fetch_columns(self, positions: np.ndarray, prefix_pts: np.ndarray,
                      bd_blocks: np.ndarray = None):
        acgt, F, multi, cov, ccov, cov_tot = self.finalize()
        fn = self._fetch_kernel(int(positions.size), int(prefix_pts.size))
        cols, pref = fn(acgt, multi, F, cov, ccov, cov_tot,
                        self._put(jnp.asarray(positions.astype(np.int64)),
                                  P(None)),
                        self._put(jnp.asarray(prefix_pts.astype(np.int64)),
                                  P(None)))
        # one packed D2H; block-depth values ride along when requested
        parts = [cols.reshape(-1).astype(pref.dtype), pref]
        nbd = 0
        if bd_blocks is not None and self._scan is not None:
            lbd = self._scan[0]
            bd_blocks = np.unique(bd_blocks)
            bd_blocks = bd_blocks[(bd_blocks >= 0) & (bd_blocks < lbd.nb)]
            nbd = bd_blocks.size
            if nbd:
                parts.append(jnp.take(
                    lbd._arr, jnp.asarray(bd_blocks.astype(np.int64))
                ).astype(pref.dtype))
        packed = np.asarray(jnp.concatenate(parts))
        nc = cols.shape[0] * cols.shape[1]
        cols_h = packed[:nc].reshape(cols.shape)
        pref_h = packed[nc:nc + pref.shape[0]]
        if nbd:
            self._scan[0].insert(bd_blocks, packed[nc + pref.shape[0]:])
        return cols_h, pref_h

    def _nor_kernel(self, NSEG: int, NE: int, NB: int):
        key = ("nor", NSEG, NE, NB)
        if key in self._kern:
            return self._kern[key]
        Pl, n, L = self.Pl, self.n, self.L

        def device_fn(cov, emitted, n_emitted, brk_sorted, n_brk):
            my = jax.lax.axis_index("dp").astype(jnp.int64)
            off = my * Pl
            pos = jnp.arange(Pl, dtype=jnp.int32)
            gpos = off + pos
            valid = gpos < L
            covm = jnp.where(valid, cov, 0)
            eon = jnp.arange(emitted.shape[0]) < n_emitted
            li = jnp.clip(emitted, 0, L - 1) - off
            ok = eon & (li >= 0) & (li < Pl)
            em_mask = jnp.zeros(Pl + 1, bool).at[
                jnp.where(ok, jnp.clip(li, 0, Pl - 1).astype(jnp.int32),
                          Pl)].set(True, mode="drop")[:Pl]
            normal = valid & (covm > 0) & ~em_mask
            key_ = jnp.searchsorted(brk_sorted, gpos,
                                    side="right").astype(jnp.int32)
            seg = jnp.where(normal, jnp.minimum(key_, NSEG - 1), NSEG - 1)
            BIG = jnp.int64(0x7FFFFFFF)
            first = jax.ops.segment_min(
                jnp.where(normal, gpos, BIG), seg, num_segments=NSEG)
            mincov = jax.ops.segment_min(
                jnp.where(normal, covm, jnp.int32(0x7FFFFFFF)), seg,
                num_segments=NSEG)
            first = jax.lax.pmin(first, "dp")
            mincov = jax.lax.pmin(mincov, "dp")
            fl = first - off
            fmine = (fl >= 0) & (fl < Pl) & (first < BIG)
            covf = jnp.where(
                fmine, covm[jnp.clip(fl, 0, Pl - 1).astype(jnp.int32)], 0)
            covf = jax.lax.psum(covf, "dp")
            return first, mincov, covf

        fn = jax.jit(jax.shard_map(
            device_fn, mesh=self.mesh,
            in_specs=(P("dp"), P(None), P(), P(None), P()),
            out_specs=(P(None), P(None), P(None))))
        self._kern[key] = fn
        return fn

    @_x64
    def nor_blocks(self, emitted: np.ndarray, brk: np.ndarray):
        from ..calling.scan_device import NOR_SEG_TIERS
        acgt, F, multi, cov, ccov, cov_tot = self.finalize()
        NSEG = next(t for t in NOR_SEG_TIERS if t > brk.size + 1)
        em = np.full(max(emitted.size, 1), -1, dtype=np.int64)
        em[:emitted.size] = emitted
        bk = np.full(max(brk.size, 1), self.L, dtype=np.int64)
        bk[:brk.size] = np.sort(brk)
        fn = self._nor_kernel(NSEG, em.size, bk.size)
        first, mincov, covf = fn(
            cov, self._put(jnp.asarray(em), P(None)),
            jnp.int64(emitted.size),
            self._put(jnp.asarray(bk), P(None)),
            jnp.int64(brk.size))
        packed = np.asarray(jnp.concatenate(
            [first, mincov.astype(first.dtype), covf.astype(first.dtype)]))
        k = first.shape[0]
        return packed[:k], packed[k:2 * k], packed[2 * k:]

    # ------------------------------------------------------------------
    def download_raw_into(self, profile) -> None:
        """Host fallback merge: identical semantics to the base class —
        the sharded planes' logical [0, L+2) prefix is what the host
        arrays hold (pad tail is all zero by construction)."""
        L = self.L
        profile.alloc_diffs() if profile.F1_diff is None else None
        profile.exact_diff += np.asarray(self.planes.exact_diff)[:L + 1]
        fd = np.asarray(self.planes.f_diff)
        profile.F1_diff += fd[0, :L + 1]
        profile.R2_diff += fd[1, :L + 1]
        profile.F2_diff += fd[2, :L + 1]
        profile.R1_diff += fd[3, :L + 1]
        profile.multi_diff += np.asarray(self.planes.multi_diff)[:L + 1]
        profile.acgt += np.asarray(self.planes.acgt)[:, :L]
