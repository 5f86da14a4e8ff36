"""Device batch runner: accelerator seeding for the mapping engine.

Batches reads across input chunks into fixed-size device batches,
runs the lockstep FM-search kernel, and hands per-read FragPair lists
back to the host pipeline. Falls back to the host oracle for reads the
fixed-capacity kernel flags as overflowed (seed- or hit-buffer).
"""
from __future__ import annotations

import os
from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..index.fmindex import FMIndex
from ..ops.fm_device import DeviceFMIndex
from ..ops.fm_search import build_seed_kernel
from .seeding import identify_simple_pairs


class DeviceBackend:
    BUCKETS = (128, 192, 256)

    def __init__(self, idx: FMIndex, cfg: Config):
        import jax
        self.idx = idx
        self.cfg = cfg
        self.fm = DeviceFMIndex.from_host(idx)
        self.batch = cfg.batch_size
        self.max_len = cfg.max_read_len
        self._kernels = {}
        self._fm3 = None
        self.pfx_k = None          # prefix-skip depth of the built fm3
        self._chain_ctx = None
        # device chaining/classification (ops/chain_device.py) in the
        # stream path; disable to fall back to hit downloads + host chaining
        self.chain_enabled = getattr(cfg, "device_chain", True)
        # capacity-overflow observability (repeat-rich genomes)
        self.n_tier_reruns = 0
        self.n_full_fallbacks = 0
        self.n_oracle_reads = 0
        # 3-step occ table: 18 B/text-row of HBM that must coexist with
        # the 1-step rows (2 B/row, always resident), the full SA
        # (<=2 GB, fm_device budget), the evidence planes (~48 B/
        # genome-base with calling, incl. scan headroom) and ~1.5 GB of
        # kernel workspace. Use it only when the whole working set fits
        # the device's memory budget (_hbm_bytes). Beyond it the 1-step
        # kernel (no table) takes over; beyond one chip entirely,
        # -shards N shards the index over the mesh.
        self._fm3_ok = (idx.sa_full is not None
                        and idx.seq_len < (1 << 31) - 2
                        and self._occ3_fits(idx, cfg))
        # genome-sharded occ3 over an N-device mesh (human-scale index):
        # lifts the single-chip HBM cap by ~N (parallel/sharded_index.py)
        self.index_shards = int(getattr(cfg, "index_shards", 0) or 0)
        # x64 big-genome mode (parallel/big_index.py): shard-relative
        # int32 occ3 rows + int64 interval/position state, auto-selected
        # when the fwd+rc text exceeds the int32 row format (the
        # reference handles this with bwtint_t = uint64 throughout,
        # ref: src/BWT_Index/bwt.h:44); cfg.big_x64 forces it for parity
        # tests on small genomes.
        self.big_x64 = bool(getattr(cfg, "big_x64", False)) or (
            idx.seq_len >= (1 << 31) - 2)
        if self.index_shards > 1:
            if len(jax.devices()) < self.index_shards:
                raise ValueError(
                    f"index_shards={self.index_shards} but only "
                    f"{len(jax.devices())} devices visible")
            if self.big_x64:
                # the x64 sharded kernel needs the full SA (routed
                # int64 gather); no 2^31 text cap
                self._fm3_ok = idx.sa_full is not None
            else:
                # the sharded kernel is the occ3 path; lift the
                # single-chip HBM cap by ~N. Row indices/counts are
                # int32 (absolute), capping text at 2^31; beyond that
                # big_x64 takes over.
                self._fm3_ok = idx.sa_full is not None and (
                    idx.seq_len < min(self.index_shards * (1 << 29),
                                      (1 << 31) - 2))
        elif self.big_x64 and idx.seq_len >= (1 << 31) - 2:
            raise ValueError(
                "genome text exceeds 2^31 rows; run with -shards N "
                "(genome-sharded x64 index) on an N-device mesh")
        self._sharded = None
        self._big = None
        # counts ACTUAL sharded-kernel dispatches: a routing escape
        # (grouped/sliced submits silently building single-chip kernels
        # under -shards) stays byte-identical on a shared-RAM CPU mesh,
        # so parity tests can't catch it — tests assert this is > 0
        self.sharded_invocations = 0
        # device-resident evidence planes: budget-gated on one chip
        # (fall back to the host C++ diff arrays when they don't fit);
        # the big sharded path keeps them genome-sharded at O(L/n) per
        # device instead (pipeline/big_profile.py)
        self.device_evidence_ok = (
            (self.big_x64 and self.index_shards > 1)
            or self._device_evidence_fits(idx, cfg))

    @staticmethod
    def _hbm_bytes() -> int:
        """Per-device memory budget: MC_HBM_BYTES when set (the explicit
        budget CPU runs need), else the share of the device that the
        JAX runtime reserved (`bytes_limit`). An accelerator that reports
        neither is an error, never a guessed size."""
        env = os.environ.get("MC_HBM_BYTES")
        if env:
            return int(env)
        import jax
        dev = jax.local_devices()[0]
        ms = dev.memory_stats()
        if ms and ms.get("bytes_limit"):
            return int(ms["bytes_limit"])
        raise RuntimeError(
            f"{dev.platform} device {dev.device_kind!r} reports no memory "
            f"limit; set MC_HBM_BYTES to the per-device budget in bytes")

    _WORKSPACE = 1_500_000_000               # stream buffers + HLO temps
    _PFX_ENTRY_BYTES = 4 * 18                # packed prefix entry, charged
                                             # 4x (embed transient)

    @staticmethod
    def _table_bytes(n: int, occ3: bool) -> int:
        """Seeding tables: occ1 rows (2 B/text-row, always resident)
        + occ3 (18 B/row) + full SA (<=2 GB, fm_device budget)."""
        return (2 * n + ((n // 16 + 2) * 288 if occ3 else 0)
                + min(4 * (n + 1), 2 << 30))

    def _occ3_fits(self, idx, cfg) -> bool:
        """Mapping working set with the 3-step table + workspace."""
        return (self._table_bytes(idx.seq_len, True) + self._WORKSPACE
                <= self._hbm_bytes())

    def _device_evidence_fits(self, idx, cfg) -> bool:
        """Evidence working set on top of mapping: the HBM planes
        (~40 B/genome-base) plus their finalize materialization
        (~44 B/base — acgt/F cumsums, coverage, cov_prefix) must
        coexist with the tables. A 200 Mb genome OOM'd exactly here
        (finalize kernel, 1-step path); beyond the budget the evidence
        planes stay in host RAM (C++ diff arrays — the reference's own
        16 B/base PFM model, structure.h:152-163) while seeding/chaining
        stay on device."""
        return (self._table_bytes(idx.seq_len, self._fm3_ok)
                + 88 * idx.genome_size + self._WORKSPACE
                <= self._hbm_bytes())

    def predicted_bytes(self, k: int) -> int:
        """The capacity model's device working set for this index with
        prefix-skip depth k (what the HBM gates above budget for)."""
        return (self._table_bytes(self.idx.seq_len, self._fm3_ok)
                + (88 * self.idx.genome_size if self.device_evidence_ok
                   else 0)
                + (self._PFX_ENTRY_BYTES * 4 ** k if k > 0 else 0)
                + self._WORKSPACE)

    def _prefix_skip_k(self) -> int:
        """Fused seed-start skip depth (identical seeds at any depth).
        CPU runs cap it at 8 (K=6 default) to keep test tables small; on
        an accelerator, -1 (auto) takes the depth with the largest
        expected skip whose table fits the memory slack."""
        import jax
        k = int(getattr(self.cfg, "prefix_skip_k", -1))
        if self.index_shards > 1:
            # the sharded paths slice occ3_rows per shard — embedded
            # prefix rows would shard wrongly (their own wrappers
            # report pfx_k = 0)
            return 0
        if jax.default_backend() == "cpu":
            return 6 if k < 0 else min(k, 8)
        if k >= 0:
            return k
        # prefix entries pack 16 per 72-int32 row (18 B/entry,
        # ops/fm3_device._embed_pfx); charge 4x the packed table for the
        # embed-concat transient + compile-time double residency.
        # A deeper skip only pays when the genome actually CONTAINS the
        # K-mer (an absent entry falls back to the 1-step init), so pick
        # the K maximizing the expected skip K * (1 - e^-lambda),
        # lambda = n / 4^K, among the depths whose table fits — not
        # simply the deepest.
        import math
        n = self.idx.seq_len
        slack = self._hbm_bytes() - self.predicted_bytes(0) - 500_000_000
        best = (0.0, 0)
        for kk in range(8, 15):
            if self._PFX_ENTRY_BYTES * (4 ** kk) > slack:
                break
            gain = kk * (1.0 - math.exp(-n / (4.0 ** kk)))
            if gain > best[0]:
                best = (gain, kk)
        return best[1]

    @property
    def fm3(self):
        if self._fm3 is None and self._fm3_ok:
            from ..ops.fm3_device import DeviceFM3
            tw = self.chain_ctx.text_words if self.chain_enabled else None
            self.pfx_k = self._prefix_skip_k()
            self._fm3 = DeviceFM3.from_host(self.idx, self.fm,
                                            pfx_k=self.pfx_k,
                                            text_words=tw)
        return self._fm3

    def device_report(self) -> dict:
        """The device this run used, the prefix-skip depth it chose,
        the capacity model's prediction and each device's measured peak
        (`peak_bytes_in_use`; None where the runtime keeps no stats)."""
        import jax
        devs = jax.local_devices()
        k = self.pfx_k or 0
        return {"platform": devs[0].platform,
                "device_kind": devs[0].device_kind,
                "device_count": len(devs),
                "prefix_skip_k": self.pfx_k,
                "predicted_bytes": self.predicted_bytes(k),
                "budget_bytes": self._hbm_bytes(),
                "peak_bytes_in_use": [(d.memory_stats() or {}).get(
                    "peak_bytes_in_use") for d in devs]}

    def release_index_tables(self) -> None:
        """Drop the device-resident seeding tables (occ3 rows incl.
        prefix entries, device SA, chain kernels). The calling phase
        reads only the evidence planes; at human scale the seed tables
        are ~52 GB that would otherwise coexist with the finalize
        outputs (the 1 Gbp calling phase OOM'd on exactly that sum).
        Call between the last mapped batch and finalize/calling; the
        tables rebuild lazily if mapping runs again."""
        import gc
        self._kernels.clear()
        self._fm3 = None
        if hasattr(self, "_sharded"):
            self._sharded = None
        if hasattr(self, "_big"):
            self._big = None
        gc.collect()

    def _kernel_for(self, bucket: int):
        if bucket not in self._kernels:
            self._kernels[bucket] = build_seed_kernel(self.fm, bucket, self.batch)
        return self._kernels[bucket]

    def seed_batch(self, codes_list: List[np.ndarray]) -> List[tuple]:
        """codes_list: per-read uint8 code arrays. Returns per-read flat
        seed arrays (rpos int32[], gpos int64[], length int32[]) with the
        PosDiff > 0 filter applied — the exact seed set of
        identify_simple_pairs, unsorted and without the sentinel."""
        return self.collect(self.submit(codes_list))

    def submit(self, codes_list: List[np.ndarray]):
        """Enqueue device seeding for all sub-batches (async dispatch);
        returns a token for collect()."""
        n = len(codes_list)
        pending = []
        for lo in range(0, n, self.batch):
            chunk = codes_list[lo:lo + self.batch]
            pending.append(self._submit_one(chunk))
        return pending

    def collect(self, pending) -> List[tuple]:
        out: List[tuple] = []
        for item in pending:
            out.extend(self._collect_one(item))
        return out

    # -- packed 2-bit API (stream path; transfer-optimized) ---------------
    def _packed_kernel_for(self, bucket: int, tier: int = 9,
                           batch: Optional[int] = None):
        B = batch or self.batch
        cf = max(1, int(getattr(self.cfg, "compact_factor", 1)))
        lanes = (B // cf) if (cf > 1 and self._fm3_ok and B % cf == 0) else 0
        key = ("packed", bucket, tier, B, lanes)
        if key not in self._kernels:
            from ..ops.fm_search import build_seed_kernel_packed
            fm = self.fm3 if self._fm3_ok else self.fm
            self._kernels[key] = build_seed_kernel_packed(
                fm, bucket, B, hits_per_read_x4=tier, compact_lanes=lanes)
        return self._kernels[key]

    def submit_packed(self, packed: np.ndarray, rlens: np.ndarray,
                      bucket: int, tier: int = 9):
        """packed uint8[B, bucket/4] 2-bit codes; negative rlen =
        host-fallback read. Async dispatch; ~8x smaller upload and ~4x
        smaller download than the byte-matrix path."""
        kernel = self._packed_kernel_for(bucket, tier, batch=packed.shape[0])
        rl = np.maximum(rlens, 0)
        packed_dev = jnp.asarray(packed)
        dev = kernel(packed_dev, jnp.asarray(rl))
        return (kernel, dev, rlens < 0, packed_dev, bucket, rlens)

    def collect_packed(self, token, n: int, read_codes_fn):
        """-> (counts, rpos, gpos, slen) grouped by read; overflow reads
        recomputed with the host oracle. Batch-level hit-buffer overflow
        reruns via a double-capacity kernel tier."""
        kernel, dev, fb_neg, packed_dev, bucket, rlens = token
        counts, rpos, gpos, slen, overflow, buf_ovf = kernel.collect(dev)
        if buf_ovf:
            kernel2 = self._packed_kernel_for(bucket, tier=18,
                                              batch=len(rlens))
            dev2 = kernel2(packed_dev, jnp.asarray(np.maximum(rlens, 0)))
            counts, rpos, gpos, slen, overflow, buf_ovf = kernel2.collect(dev2)
            if buf_ovf:   # pathological: host oracle for everything
                fallback = np.ones(n, dtype=bool)
                counts = np.zeros(n, dtype=np.int32)
                rpos = np.zeros(0, np.int32); gpos = np.zeros(0, np.int64)
                slen = np.zeros(0, np.int32)
                return self._splice_fallback(n, counts, rpos, gpos, slen,
                                             fallback, read_codes_fn)
        fallback = overflow[:n] | fb_neg[:n]
        counts = counts[:n]
        if fallback.any():
            # drop device hits of fallback reads, then splice oracle seeds
            bounds = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(counts, out=bounds[1:])
            keep = np.ones(len(rpos), dtype=bool)
            for i in np.nonzero(fallback)[0].tolist():
                keep[bounds[i]:bounds[i + 1]] = False
            rpos, gpos, slen = rpos[keep], gpos[keep], slen[keep]
            counts = counts.copy()
            counts[fallback] = 0
            return self._splice_fallback(n, counts, rpos, gpos, slen,
                                         fallback, read_codes_fn)
        return counts, rpos.astype(np.int32), gpos, slen.astype(np.int32)

    def _splice_fallback(self, n, counts, rpos, gpos, slen, fallback,
                         read_codes_fn):
        bounds = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=bounds[1:])
        rp_parts, gp_parts, ln_parts = [], [], []
        prev = 0
        for i in np.nonzero(fallback)[0].tolist():
            s = int(bounds[i])
            rp_parts.append(rpos[prev:s]); gp_parts.append(gpos[prev:s])
            ln_parts.append(slen[prev:s])
            orp, ogp, oln = self._oracle_arrays(read_codes_fn(i))
            rp_parts.append(orp); gp_parts.append(ogp); ln_parts.append(oln)
            counts[i] = len(orp)
            prev = s
        rp_parts.append(rpos[prev:]); gp_parts.append(gpos[prev:])
        ln_parts.append(slen[prev:])
        return (counts,
                np.concatenate(rp_parts).astype(np.int32),
                np.concatenate(gp_parts).astype(np.int64),
                np.concatenate(ln_parts).astype(np.int32))

    # -- seeding + device chaining/classification (production path) ------
    def _chain_kernel_for(self, bucket: int, tier: int = 2,
                          batch: Optional[int] = None,
                          with_planes: bool = False,
                          pair_end: bool = False):
        B = batch or self.batch
        cf = max(1, int(getattr(self.cfg, "compact_factor", 1)))
        lanes = (B // cf) if (cf > 1 and self._fm3_ok and B % cf == 0) else 0
        key = ("chain", bucket, tier, B, with_planes, pair_end, lanes)
        if key not in self._kernels:
            from ..ops.fm_search import build_seed_chain_kernel
            fm = self.fm3 if self._fm3_ok else self.fm
            self._kernels[key] = build_seed_chain_kernel(
                fm, self.chain_ctx, bucket, B, slow_hits_x4=tier,
                with_planes=with_planes, pair_end=pair_end,
                compact_lanes=lanes)
        return self._kernels[key]

    @property
    def chain_ctx(self):
        if self._chain_ctx is None:
            from ..ops.chain_device import ChainCtx
            self._chain_ctx = ChainCtx.from_host(self.idx)
        return self._chain_ctx

    def _sharded_setup(self):
        if self._sharded is None:
            import jax
            from jax.sharding import NamedSharding, PartitionSpec as P
            from ..parallel.mesh import make_mesh
            from ..parallel.sharded_index import shard_occ3_rows
            n = self.index_shards
            mesh = make_mesh(n)

            def put(a, spec):
                return jax.device_put(jnp.asarray(a),
                                      NamedSharding(mesh, spec))

            def pad_split(a):
                a = np.asarray(a)
                per = -(-a.shape[0] // n)
                pad = np.zeros((n * per,) + a.shape[1:], dtype=a.dtype)
                pad[:a.shape[0]] = a
                return pad.reshape((n, per) + a.shape[1:])

            slices, _ = shard_occ3_rows(self.fm3, n)
            occ_dev = put(slices, P("dp", None, None))
            # SA resolution tables, sharded to match the single-chip
            # policy branch (ops/fm_device.sa_resolve)
            if self.fm.has_full_sa:
                sa_dev = put(pad_split(self.fm.sa_full), P("dp", None))
                occ1_dev = put(np.zeros((n, 1, 8), np.int32),
                               P("dp", None, None))
            else:
                occ1_dev = put(pad_split(self.fm.occ_rows),
                               P("dp", None, None))
                sa_dev = put(pad_split(self.fm.sa_samp), P("dp", None))
            self._sharded = (mesh, occ_dev, occ1_dev, sa_dev)
        return self._sharded

    def _big_setup(self):
        """Stage the x64 big-genome sharded tables: shard-relative occ3
        rows (+ int64 base counts), int64 full SA, and the replicated
        chain context, all device-placed over the dp mesh."""
        if self._big is None:
            import jax
            from jax.sharding import NamedSharding, PartitionSpec as P
            from ..index.occ3 import build_occ3_64
            from ..parallel.mesh import make_mesh
            n = self.index_shards
            mesh = make_mesh(n)
            idx = self.idx
            # Memory-lean staging (the first 1 Gbp HUMAN_SCALE attempt
            # OOM'd at 130 GB holding host+device copies of every
            # table at once): the full SA rides straight from its
            # read-only index memmap (no astype copy — the int32 form
            # feeds mc_build_occ3_64s directly and upconverts per
            # 2 GB shard), the 36 GB occ3 rows build into a disk-backed
            # temp memmap whose clean pages the kernel can evict, and
            # each host-side source is dropped as soon as its device
            # copy exists.
            import tempfile
            sa_src = idx.sa_full
            text = idx.ref.fwd_rc_codes()
            nrows = idx.seq_len
            nw3 = (nrows + 16) // 16 + 2
            rps = -(-nw3 // n)
            rows_f = tempfile.NamedTemporaryFile(
                prefix="mc_occ3_", suffix=".bin", delete=False)
            rows = np.memmap(rows_f.name, dtype=np.int32, mode="w+",
                             shape=(n * rps, 72))
            tab = build_occ3_64(sa_src, text, words_per_shard=rps,
                                rows_out=rows[:nw3])
            del text
            devs = list(mesh.devices.reshape(-1))

            def stage_sharded(arr2d, spec_shape):
                shards = [jax.device_put(np.ascontiguousarray(
                    arr2d[s])[None], d) for s, d in enumerate(devs)]
                return jax.make_array_from_single_device_arrays(
                    (n,) + arr2d.shape[1:],
                    NamedSharding(mesh, spec_shape), shards)

            with jax.enable_x64(True):
                occ_dev = stage_sharded(rows.reshape(n, rps, 72),
                                        P("dp", None, None))
                del rows
                try:
                    os.unlink(rows_f.name)
                except OSError:
                    pass
                sps = -(-(nrows + 1) // n)

                def sa_shard(s):
                    lo = s * sps
                    hi = min(lo + sps, nrows + 1)
                    buf = np.zeros(sps, dtype=np.int64)
                    buf[:hi - lo] = sa_src[lo:hi]
                    return buf

                sa_dev = jax.make_array_from_single_device_arrays(
                    (n, sps), NamedSharding(mesh, P("dp", None)),
                    [jax.device_put(sa_shard(s)[None], d)
                     for s, d in enumerate(devs)])
                base3 = np.zeros((n, 64), dtype=np.int64)
                base3[:tab.base3.shape[0]] = tab.base3

                def rep(a):
                    return jax.device_put(jnp.asarray(a),
                                          NamedSharding(mesh, P(*([None] *
                                                        np.ndim(a)))))

                b3 = rep(base3)
                c3f = rep(tab.c3_first)
                l2d = rep(np.asarray(idx.L2, dtype=np.int64))
                ctx = self.chain_ctx
                tw = rep(np.asarray(ctx.text_words))
                bk = rep(np.asarray(ctx.bkeys).astype(np.int64))
            statics = dict(primary=int(idx.primary), row_p1=tab.row_p1,
                           row_p2=tab.row_p2, t0=tab.t0, t1=tab.t1,
                           tail1=tab.tail1, tail2a=tab.tail2a,
                           tail2b=tab.tail2b)
            self._big = (mesh, occ_dev, b3, c3f, l2d, sa_dev, tw, bk,
                         statics)
        return self._big

    def _sharded_chain_for(self, bucket: int, tier: int, batch_global: int):
        key = ("schain", bucket, tier, batch_global, self.big_x64)
        if key not in self._kernels:
            cls_ = _BigShardedChain if self.big_x64 else _ShardedChain
            self._kernels[key] = cls_(self, bucket, tier, batch_global)
        return self._kernels[key]

    def submit_chain(self, packed: np.ndarray, rlens: np.ndarray,
                     bucket: int, tier: int = 2, evidence=None,
                     pair_end: bool = False):
        """evidence (a DeviceEvidence) folds the speculative fast-read
        evidence apply into this dispatch; the caller must later run
        evidence.reconcile_batch(token, fast_bits, pair_end).

        With cfg.index_shards > 1 the chain stage runs genome-sharded
        over the device mesh (occ3 rows split; routed gathers); the
        token and collect contract are unchanged. The folded-evidence
        path is single-chip only (the sharded kernel returns the same
        pd/mmp for the classic apply)."""
        if self.index_shards > 1 and self._fm3_ok:
            import jax
            from jax.sharding import NamedSharding, PartitionSpec as P
            n = self.index_shards
            B0 = packed.shape[0]
            BG = -(-B0 // n) * n
            packed_p = np.zeros((BG, packed.shape[1]), dtype=packed.dtype)
            packed_p[:B0] = packed
            rl_p = np.zeros(BG, dtype=np.int32)
            rl_p[:B0] = np.maximum(rlens, 0)
            mesh = (self._big_setup() if self.big_x64
                    else self._sharded_setup())[0]
            kernel = self._sharded_chain_for(bucket, tier, BG)
            packed_dev = jax.device_put(jnp.asarray(packed_p),
                                        NamedSharding(mesh, P("dp", None)))
            rl_dev = jax.device_put(jnp.asarray(rl_p),
                                    NamedSharding(mesh, P("dp")))
            dev, pd_dev, mmp_dev = kernel(packed_dev, rl_dev)
            self.sharded_invocations += 1
            return [kernel, dev, rlens < 0, packed_dev, bucket, rlens,
                    pd_dev, mmp_dev, rl_dev]
        rl = np.maximum(rlens, 0)
        packed_dev = jnp.asarray(packed)
        rl_dev = jnp.asarray(rl)
        # mutable: a tier rerun in collect_chain swaps in the larger
        # kernel's outputs so the evidence kernel never sees stale pd/mmp
        if evidence is not None:
            kernel = self._chain_kernel_for(
                bucket, tier, batch=packed.shape[0], with_planes=True,
                pair_end=pair_end)
            dev, pd_dev, mmp_dev, evidence.planes = kernel(
                packed_dev, rl_dev, evidence.planes)
            return [kernel, dev, rlens < 0, packed_dev, bucket, rlens,
                    pd_dev, mmp_dev, rl_dev, (dev, pd_dev, mmp_dev)]
        kernel = self._chain_kernel_for(bucket, tier, batch=packed.shape[0])
        dev, pd_dev, mmp_dev = kernel(packed_dev, rl_dev)
        return [kernel, dev, rlens < 0, packed_dev, bucket, rlens,
                pd_dev, mmp_dev, rl_dev]

    def submit_chain_sliced(self, packed_dev, rl_dev, rlens: np.ndarray,
                            bucket: int, tier: int = 2):
        """Like submit_chain, but the 2-bit codes are already device-
        resident (one bulk upload covers many batches; per-batch views
        are eager device slices, so the link pays one transfer instead
        of one per batch)."""
        if self.index_shards > 1:
            raise RuntimeError(
                "submit_chain_sliced builds single-chip kernels and would "
                "silently bypass the sharded-index path under -shards")
        kernel = self._chain_kernel_for(bucket, tier,
                                        batch=int(packed_dev.shape[0]))
        dev, pd_dev, mmp_dev = kernel(packed_dev, rl_dev)
        return [kernel, dev, rlens < 0, packed_dev, bucket, rlens,
                pd_dev, mmp_dev, rl_dev]

    def submit_chain_group(self, parts, bucket: int, pair_end: bool = False):
        """Transfer-grouped submission: ONE H2D upload carries g batches'
        codes and ONE D2H carries their packed outputs — on ~50 ms/
        transfer-latency links this cuts the per-batch
        round-trip cost by (g-1)/g while per-batch kernels, collect
        semantics, tier reruns and the evidence apply stay unchanged.

        parts: list of (packed uint8[B, bucket/4], rlens int32[B]).
        Returns (tokens, group); the caller resolves `group` once via
        resolve_chain_group() before collecting any member token."""
        g = len(parts)
        B = parts[0][0].shape[0]
        big = np.concatenate([p for p, _ in parts], axis=0)
        rl = np.concatenate([np.maximum(r, 0).astype(np.int32)
                             for _, r in parts])
        big_dev = jnp.asarray(big)
        rl_dev = jnp.asarray(rl)
        tokens = []
        for i in range(g):
            sl = slice(i * B, (i + 1) * B)
            tokens.append(self.submit_chain_sliced(
                big_dev[sl], rl_dev[sl], parts[i][1], bucket))
        gd = jnp.concatenate([t[1] for t in tokens])
        try:
            gd.copy_to_host_async()
        except Exception:
            pass
        group = {"gd": gd, "sizes": [int(t[1].shape[0]) for t in tokens],
                 "tokens": tokens}
        return tokens, group

    @staticmethod
    def resolve_chain_group(group) -> None:
        """Materialize the group's single D2H and hand each member its
        host slice (idempotent)."""
        if group.get("gd") is None:
            return
        host = np.asarray(group["gd"])
        off = 0
        for t, n in zip(group["tokens"], group["sizes"]):
            t[1] = host[off:off + n]
            off += n
        group["gd"] = None

    def collect_chain(self, token, n: int, read_codes_fn):
        """-> (cls, pd, mm, rplast, cscore, counts, rpos, gpos, slen).
        Overflow / too-long reads are re-seeded with the host oracle and
        forced to the SLOW class; hit-buffer overflow reruns at a larger
        tier."""
        from ..ops.chain_device import CLASS_SLOW
        kernel, dev, fb_neg, packed_dev, bucket, rlens = token[:6]
        out = kernel.collect(dev)
        (cls, pd, mm, rplast, cscore, counts, rpos, gpos, slen,
         overflow, buf_ovf) = out
        if buf_ovf:
            self.n_tier_reruns += 1
            rb = getattr(kernel, "rerun_builder", None)
            kernel2 = (rb(18) if rb is not None else
                       self._chain_kernel_for(bucket, tier=18,
                                              batch=len(rlens)))
            dev2, pd2, mmp2 = kernel2(packed_dev,
                                      jnp.asarray(np.maximum(rlens, 0)))
            (cls, pd, mm, rplast, cscore, counts, rpos, gpos, slen,
             overflow, buf_ovf) = kernel2.collect(dev2)
            # refresh the token: downstream evidence (apply_batch) must
            # use the SAME classification outputs the host admits from
            token[0], token[1] = kernel2, dev2
            token[6], token[7] = pd2, mmp2
            if buf_ovf:   # pathological: host oracle for everything
                self.n_full_fallbacks += 1
                cls = np.full(n, CLASS_SLOW, dtype=np.int32)
                counts = np.zeros(n, dtype=np.int32)
                return self._splice_chain(
                    n, cls[:n], pd[:n], mm[:n], rplast[:n], cscore[:n],
                    counts, np.zeros(0, np.int32), np.zeros(0, np.int64),
                    np.zeros(0, np.int32), np.ones(n, dtype=bool),
                    read_codes_fn)
        fallback = overflow[:n] | fb_neg[:n]
        cls = cls[:n].copy()
        counts = counts[:n]
        self.n_oracle_reads += int(fallback.sum())
        if fallback.any():
            # drop device hits of fallback reads, then splice oracle seeds
            bounds = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(counts, out=bounds[1:])
            keep = np.ones(len(rpos), dtype=bool)
            for i in np.nonzero(fallback)[0].tolist():
                keep[bounds[i]:bounds[i + 1]] = False
            rpos, gpos, slen = rpos[keep], gpos[keep], slen[keep]
            counts = counts.copy()
            counts[fallback] = 0
            return self._splice_chain(n, cls, pd[:n], mm[:n], rplast[:n],
                                      cscore[:n], counts, rpos, gpos, slen,
                                      fallback, read_codes_fn)
        return (cls, pd[:n], mm[:n], rplast[:n], cscore[:n], counts,
                rpos.astype(np.int32), gpos, slen.astype(np.int32))

    def _splice_chain(self, n, cls, pd, mm, rplast, cscore, counts,
                      rpos, gpos, slen, fallback, read_codes_fn):
        from ..ops.chain_device import CLASS_SLOW
        cls[fallback] = CLASS_SLOW
        counts, rpos, gpos, slen = self._splice_fallback(
            n, counts, rpos, gpos, slen, fallback, read_codes_fn)
        return cls, pd, mm, rplast, cscore, counts, rpos, gpos, slen

    # -- flat matrix API (stream path: native parser provides the batch) --
    def submit_matrix(self, codes: np.ndarray, rlens: np.ndarray, bucket: int):
        """codes uint8[batch, bucket], rlens int32[batch] (negative length
        = read too long for the bucket -> per-read fallback). Async."""
        kernel = self._kernel_for(bucket)
        codes_dev = jnp.asarray(codes)
        dev = kernel.submit(codes_dev, jnp.asarray(rl := np.maximum(rlens, 0)))
        try:
            dev.copy_to_host_async()   # D2H overlaps host work
        except Exception:
            pass
        # codes_dev stays resident for the batch's later PFM scatter
        return (kernel, dev, rlens < 0, codes_dev)

    def collect_flat(self, token, n: int, codes: np.ndarray,
                     rlens: np.ndarray, read_codes_fn):
        """-> (counts int32[n], rpos int32[], gpos int64[], slen int32[])
        flat seed arrays grouped by read, PosDiff>0 filter applied.
        Overflowed reads are recomputed with the host oracle."""
        kernel, dev, too_long, _codes_dev = token
        (hit_read, hit_rpos, hit_len, hit_loc, hit_valid,
         total, overflow, buf_ovf) = kernel.collect(dev)
        if bool(buf_ovf):
            fallback = np.ones(n, dtype=bool)
        else:
            fallback = (overflow[:n] | too_long[:n])
        pd = hit_loc.astype(np.int64) - hit_rpos
        keep = hit_valid & (pd > 0)
        hr = hit_read[keep]
        inb = hr < n
        hr = hr[inb]
        rp = hit_rpos[keep][inb].astype(np.int32)
        gp = hit_loc[keep][inb].astype(np.int64)
        ln = hit_len[keep][inb].astype(np.int32)
        if fallback.any():
            ok = ~fallback[hr]
            hr, rp, gp, ln = hr[ok], rp[ok], gp[ok], ln[ok]
            counts = np.bincount(hr, minlength=n)[:n].astype(np.int32)
            # splice oracle seeds for fallback reads at their positions
            bounds = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(counts, out=bounds[1:])
            rp_parts, gp_parts, ln_parts = [], [], []
            prev = 0
            for i in np.nonzero(fallback)[0].tolist():
                s = int(bounds[i])
                rp_parts.append(rp[prev:s]); gp_parts.append(gp[prev:s])
                ln_parts.append(ln[prev:s])
                c = (read_codes_fn(i) if too_long[i]
                     else codes[i, :rlens[i]])
                orp, ogp, oln = self._oracle_arrays(np.asarray(c, dtype=np.uint8))
                rp_parts.append(orp); gp_parts.append(ogp); ln_parts.append(oln)
                counts[i] = len(orp)
                prev = s
            rp_parts.append(rp[prev:]); gp_parts.append(gp[prev:])
            ln_parts.append(ln[prev:])
            rp = np.concatenate(rp_parts); gp = np.concatenate(gp_parts)
            ln = np.concatenate(ln_parts)
        else:
            counts = np.bincount(hr, minlength=n)[:n].astype(np.int32)
        return counts, rp, gp, ln

    def _oracle_arrays(self, c: np.ndarray) -> tuple:
        pairs = identify_simple_pairs(self.idx, c)[:-1]  # drop sentinel
        return (np.array([p.rPos for p in pairs], dtype=np.int32),
                np.array([p.gPos for p in pairs], dtype=np.int64),
                np.array([p.rLen for p in pairs], dtype=np.int32))

    def _submit_one(self, chunk: List[np.ndarray]):
        B = self.batch
        longest = max((c.shape[0] for c in chunk), default=0)
        bucket = next((b for b in self.BUCKETS
                       if b >= min(longest, self.max_len)), self.BUCKETS[-1])
        codes = np.full((B, bucket), 4, dtype=np.uint8)
        rlens = np.zeros(B, dtype=np.int32)
        fallback = [False] * len(chunk)
        for i, c in enumerate(chunk):
            if c.shape[0] > bucket:
                fallback[i] = True
                continue
            codes[i, :c.shape[0]] = c
            rlens[i] = c.shape[0]
        kernel = self._kernel_for(bucket)
        dev = kernel.submit(jnp.asarray(codes), jnp.asarray(rlens))
        try:
            dev.copy_to_host_async()
        except Exception:
            pass
        return (kernel, dev, chunk, fallback)

    def _collect_one(self, item) -> List[tuple]:
        kernel, dev, chunk, fallback = item
        B = self.batch
        (hit_read, hit_rpos, hit_len, hit_loc, hit_valid,
         total, overflow, buf_ovf) = kernel.collect(dev)
        if bool(buf_ovf):
            # batch-level hit-buffer overflow: host fallback for everything
            return [self._oracle_arrays(c) for c in chunk]
        pd = hit_loc.astype(np.int64) - hit_rpos
        keep = hit_valid & (pd > 0)
        order_read = hit_read[keep]
        rp = hit_rpos[keep].astype(np.int32)
        gp = hit_loc[keep].astype(np.int64)
        ln = hit_len[keep].astype(np.int32)
        # hits are already grouped by read (flattened seed order)
        bounds = np.searchsorted(order_read, np.arange(B + 1))
        result = []
        for i, c in enumerate(chunk):
            if fallback[i] or overflow[i]:
                result.append(self._oracle_arrays(c))
            else:
                s, e = bounds[i], bounds[i + 1]
                result.append((rp[s:e], gp[s:e], ln[s:e]))
        return result


class _ShardedChain:
    """Adapter giving the genome-sharded chain kernel
    (parallel/sharded_index.build_sharded_chain_kernel) the same
    __call__/collect/rerun contract as the single-chip kernel, so
    collect_chain and the evidence path work unchanged. Slow-hit
    compaction happens host-side here (the single-chip kernel's packed
    layout is a transfer optimization)."""

    def __init__(self, be: DeviceBackend, bucket: int, tier: int,
                 batch_global: int):
        from ..parallel.sharded_index import build_sharded_chain_kernel
        self.be = be
        self.bucket = bucket
        self.tier = tier
        self.BG = batch_global
        self.n = be.index_shards
        (self.mesh, self.occ_dev, self.occ1_dev,
         self.sa_dev) = be._sharded_setup()
        self.fn = build_sharded_chain_kernel(
            be.fm3, be.chain_ctx, self.mesh, self.n, bucket, batch_global,
            tier)

    def __call__(self, packed_dev, rl_dev):
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        if int(rl_dev.shape[0]) != self.BG:       # rerun passes unpadded
            rl_p = np.zeros(self.BG, dtype=np.int32)
            rl_p[:int(rl_dev.shape[0])] = np.asarray(rl_dev)
            rl_dev = jax.device_put(jnp.asarray(rl_p),
                                    NamedSharding(self.mesh, P("dp")))
        outs = self.fn(self.occ_dev, self.occ1_dev, self.sa_dev,
                       packed_dev, rl_dev)
        return outs, outs[1], outs[5]

    def rerun_builder(self, tier: int):
        return self.be._sharded_chain_for(self.bucket, tier, self.BG)

    def collect(self, outs):
        (cls, pd0, mm, rplast, cscore, mmp, ovf, hit_read, hit_rpos,
         hit_len, hit_loc, keep_slow, buf_ovf) = [np.asarray(x)
                                                  for x in outs]
        k = keep_slow.astype(bool)
        counts = np.bincount(hit_read[k],
                             minlength=self.BG)[:self.BG].astype(np.int32)
        order = np.argsort(hit_read[k], kind="stable")
        rpos = hit_rpos[k][order].astype(np.int32)
        gpos = hit_loc[k][order].astype(np.int64)
        slen = hit_len[k][order].astype(np.int32)
        return (cls, pd0, mm, rplast, cscore, counts, rpos, gpos, slen,
                ovf.astype(bool), bool(buf_ovf.any()))


class _BigShardedChain:
    """x64 big-genome variant of _ShardedChain: the chain stage runs
    parallel/big_index.build_big_chain_kernel (shard-relative occ3 rows,
    int64 interval state / hit locations / diagonals), same
    __call__/collect/rerun contract. Auto-selected by the backend when
    the fwd+rc text has >= 2^31 rows (ref index types are uint64:
    src/BWT_Index/bwt.h:44); cfg.big_x64 forces it for parity tests."""

    def __init__(self, be: DeviceBackend, bucket: int, tier: int,
                 batch_global: int):
        import jax
        from ..parallel.big_index import build_big_chain_kernel
        self.be = be
        self.bucket = bucket
        self.tier = tier
        self.BG = batch_global
        self.n = be.index_shards
        (self.mesh, self.occ_dev, self.b3, self.c3f, self.l2d,
         self.sa_dev, self.tw, self.bk, self.statics) = be._big_setup()
        with jax.enable_x64(True):
            self.fn = build_big_chain_kernel(
                self.mesh, self.n, bucket, batch_global, self.statics,
                int(be.idx.seq_len), tier)

    def __call__(self, packed_dev, rl_dev):
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        with jax.enable_x64(True):
            if int(rl_dev.shape[0]) != self.BG:   # rerun passes unpadded
                rl_p = np.zeros(self.BG, dtype=np.int32)
                rl_p[:int(rl_dev.shape[0])] = np.asarray(rl_dev)
                rl_dev = jax.device_put(jnp.asarray(rl_p),
                                        NamedSharding(self.mesh, P("dp")))
            outs = self.fn(self.occ_dev, self.b3, self.c3f, self.l2d,
                           self.sa_dev, self.tw, self.bk, packed_dev,
                           rl_dev)
        return outs, outs[1], outs[5]

    def rerun_builder(self, tier: int):
        return self.be._sharded_chain_for(self.bucket, tier, self.BG)

    def collect(self, outs):
        return _ShardedChain.collect(self, outs)
