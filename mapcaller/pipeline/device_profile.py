"""HBM-resident evidence planes, updated on-device (north star: the
PFM / orientation / multi-hit tables live in HBM and are updated by
device kernels, ref contract: src/AlignmentProfile.cpp:41-242).

Layout (int32, genome_size = L):

  acgt        [4, L+1]   mismatch point adds (uncapped; capped at the
                         finalize fold, exact for +1 streams)
  exact_diff  [L+2]      +1/-1 endpoints of exact-match coverage; holes
                         punched at mismatch positions of fast reads
  f_diff      [4, L+2]   F1/R2/F2/R1 orientation range endpoints
  multi_diff  [L+2]      multi-hit span endpoints

The per-batch apply kernel consumes
  * the batch's device-resident chain outputs (diagonal pd, packed
    mismatch positions, read lengths) for FAST-class reads plus a host
    bitmask of which of them were admitted (uniquely mapped AND passed
    the PCR-duplicate gate — the gate counter stays host-side: it is a
    strictly sequential per-start counter, ~1 cache miss/read, and
    keeping it on host means every device update is a commutative
    scatter-add), and
SLOW-read evidence (6% of reads on typical data, but mismatch-dense:
~90 ops each) accumulates on the host diff arrays exactly as before;
its sparse nonzero deltas merge into the device planes once at
finalize (~1 MB for a full run vs multi-MB per-batch op uploads).

Extra slots (the +1/+2) are scatter dump targets for masked-out lanes.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

MAX_ALLELE_COUNT = 4095

@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class DevicePlanes:
    acgt: jnp.ndarray
    exact_diff: jnp.ndarray
    f_diff: jnp.ndarray
    multi_diff: jnp.ndarray
    L: int

    def tree_flatten(self):
        return ((self.acgt, self.exact_diff, self.f_diff, self.multi_diff),
                (self.L,))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @classmethod
    def zeros(cls, L: int) -> "DevicePlanes":
        return cls(acgt=jnp.zeros((4, L + 1), jnp.int32),
                   exact_diff=jnp.zeros(L + 2, jnp.int32),
                   f_diff=jnp.zeros((4, L + 2), jnp.int32),
                   multi_diff=jnp.zeros(L + 2, jnp.int32),
                   L=L)


@functools.lru_cache(maxsize=None)
def build_apply_kernel(L: int, two_l: int, B: int, pair_end: bool,
                       source: str = "bits", sign: int = 1):
    """jit fn(planes, pd[B], mmp[B,8], rlens[B], sel) -> planes.
    Applies (sign=+1) or retracts (sign=-1) FAST reads' evidence:
    coverage + orientation range endpoints, mismatch holes, read-base
    point adds (ref semantics: AlignmentProfile.cpp:41-119 via the diff
    design). source='bits': sel is the host admit bitmask [B/32];
    source='meta': sel is the chain kernel's packed output buffer and
    the admitted set is every device-classified FAST read (speculative
    fold — corrected later via build_correct_kernel)."""
    from ..ops.chain_device import CLASS_FAST
    from ..ops.evidence import scatter_fast_evidence

    def kernel(planes: DevicePlanes, pd, mmp, rlens, sel):
        bidx = jnp.arange(B, dtype=jnp.int32)
        if source == "meta":
            adm = (sel[:B] & 3) == CLASS_FAST
        else:
            adm = ((sel[bidx >> 5] >> (bidx & 31)) & 1) == 1
        if pair_end:
            b_first = (bidx & 1) == 0
        else:
            b_first = jnp.ones(B, bool)
        exact, fd, acgt = scatter_fast_evidence(
            planes.exact_diff, planes.f_diff.reshape(-1),
            planes.acgt.reshape(-1), adm, pd, mmp, rlens, b_first,
            L, two_l, sign)
        return DevicePlanes(acgt=acgt.reshape(4, L + 1),
                            exact_diff=exact,
                            f_diff=fd.reshape(4, L + 2),
                            multi_diff=planes.multi_diff, L=L)

    return jax.jit(kernel, donate_argnums=(0,))


@functools.lru_cache(maxsize=None)
def build_correct_kernel(L: int, two_l: int, B: int, pair_end: bool,
                         R: int):
    """jit fn(planes, pd[B], mmp[B,8], rlens[B], rej_idx[R]) -> planes.
    Sparse retraction for the folded/speculative apply: rej_idx holds
    read indices whose speculative evidence must be subtracted (host
    dup-gate rejects, splice-forced slow reads); pad with B. Gathers the
    R rejected lanes from the device-resident chain outputs and
    scatter-subtracts their contributions — O(R), not O(B)."""
    from ..ops.evidence import scatter_fast_evidence

    def kernel(planes: DevicePlanes, pd, mmp, rlens, rej_idx):
        on = rej_idx < B
        ix = jnp.minimum(rej_idx, B - 1)
        pd_r = pd[ix]
        mmp_r = mmp[ix]
        rl_r = rlens[ix]
        if pair_end:
            b_first = (ix & 1) == 0
        else:
            b_first = jnp.ones(R, bool)
        exact, fd, acgt = scatter_fast_evidence(
            planes.exact_diff, planes.f_diff.reshape(-1),
            planes.acgt.reshape(-1), on, pd_r, mmp_r, rl_r, b_first,
            L, two_l, sign=-1)
        return DevicePlanes(acgt=acgt.reshape(4, L + 1),
                            exact_diff=exact,
                            f_diff=fd.reshape(4, L + 2),
                            multi_diff=planes.multi_diff, L=L)

    return jax.jit(kernel, donate_argnums=(0,))


@functools.lru_cache(maxsize=None)
def build_host_merge_kernel(L: int, Na: int, Ne: int, Nf: int, Nm: int):
    """Scatter-add the host profile's sparse nonzero deltas (slow-read
    evidence) into the device planes: one call at finalize. idx arrays
    address the flattened planes; n marks valid prefix length. Each
    array gets its OWN tier — one shared tier paid 4x the largest
    array's padding in upload bytes (the link is the cost here)."""

    def kernel(planes: DevicePlanes, idx_a, val_a, n_a, idx_e, val_e, n_e,
               idx_f, val_f, n_f, idx_m, val_m, n_m):
        acgt = planes.acgt.reshape(-1)
        on = jnp.arange(Na, dtype=jnp.int32)
        acgt = acgt.at[jnp.where(on < n_a, idx_a, 4 * (L + 1) - 1)].add(
            jnp.where(on < n_a, val_a, 0), mode="drop")
        on = jnp.arange(Ne, dtype=jnp.int32)
        exact = planes.exact_diff.at[
            jnp.where(on < n_e, idx_e, L + 1)].add(
            jnp.where(on < n_e, val_e, 0), mode="drop")
        fd = planes.f_diff.reshape(-1)
        on = jnp.arange(Nf, dtype=jnp.int32)
        fd = fd.at[jnp.where(on < n_f, idx_f, 4 * (L + 2) - 1)].add(
            jnp.where(on < n_f, val_f, 0), mode="drop")
        on = jnp.arange(Nm, dtype=jnp.int32)
        multi = planes.multi_diff.at[
            jnp.where(on < n_m, idx_m, L + 1)].add(
            jnp.where(on < n_m, val_m, 0), mode="drop")
        return DevicePlanes(acgt=acgt.reshape(4, L + 1), exact_diff=exact,
                            f_diff=fd.reshape(4, L + 2), multi_diff=multi,
                            L=L)

    return jax.jit(kernel, donate_argnums=(0,))


@functools.lru_cache(maxsize=None)
def build_finalize_kernel(L: int):
    """Fold the diff endpoints (mirrors Profile.finalize_diffs): returns
    (acgt_final int32[4,L] capped with exact coverage credited to the
    reference base, F int32[4,L], multi int32[L] capped, cov int32[L],
    cov_prefix int32[L+1])."""

    def kernel(planes: DevicePlanes, ref_codes):
        exact = jnp.cumsum(planes.exact_diff[:L])
        rc = ref_codes[:L]
        acgt = planes.acgt[:, :L] + (jnp.arange(4, dtype=jnp.int32)[:, None]
                                     == rc[None, :]) * exact[None, :]
        acgt = jnp.minimum(acgt, MAX_ALLELE_COUNT)
        F = jnp.cumsum(planes.f_diff[:, :L], axis=1)
        multi = jnp.minimum(jnp.cumsum(planes.multi_diff[:L]),
                            MAX_ALLELE_COUNT)
        cov = acgt.sum(axis=0)
        cov_prefix = jnp.concatenate([jnp.zeros(1, jnp.int32),
                                      jnp.cumsum(cov)])
        return acgt, F, multi, cov, cov_prefix

    return jax.jit(kernel)


def _pad(a: np.ndarray, n: int, dtype=np.int32) -> np.ndarray:
    out = np.zeros(n, dtype=dtype)
    out[:a.size] = a
    return out


def _bucket(n: int, cap: int) -> int:
    """Power-of-two prefix length >= n (capped), so slice programs are
    reused across runs.  Consumers only ever read [:n] (an overflowing
    n makes the caller fall back before indexing, device_call.py:34)."""
    k = 1024
    while k < n:
        k <<= 1
    return min(k, cap)


def make_device_evidence(backend, cfg, host_profile):
    """DeviceEvidence factory: the big-genome sharded backend
    (cfg.big_x64 / auto at >=2^31 text rows, with index_shards > 1)
    gets genome-sharded planes (pipeline/big_profile.BigDeviceEvidence)
    so no per-position array ever materializes on a single device —
    human-scale genomes need ~16 B/base across acgt+diff planes, beyond
    one chip's HBM. Everything else keeps the single-chip planes."""
    if getattr(backend, "big_x64", False) and backend.index_shards > 1:
        from .big_profile import BigDeviceEvidence
        return BigDeviceEvidence(backend, cfg, host_profile)
    if getattr(backend, "is_multi_device", False):
        from ..parallel.devices import MultiDeviceEvidence
        return MultiDeviceEvidence(backend, cfg, host_profile)
    return DeviceEvidence(backend, cfg, host_profile)


class DeviceEvidence:
    """Owns the HBM planes for one run: per-batch apply of fast-read
    evidence + the finalize fold (which first merges the host-side
    slow-read deltas) + the dense caller scan + sparse column fetches.
    Falls back to a full plane download for gVCF/monomorphic/observe."""

    MERGE_TIERS = (1 << 14, 1 << 16, 1 << 17, 1 << 18, 1 << 19,
                   1 << 20, 1 << 21, 1 << 23)

    def __init__(self, backend, cfg, host_profile):
        self.be = backend
        self.cfg = cfg
        self.host_profile = host_profile
        self.L = backend.idx.genome_size
        self.two_l = backend.idx.seq_len
        self.planes = DevicePlanes.zeros(self.L)
        self._final = None
        self._scan = None
        self._scan_pending = None

    def apply_batch(self, token, fast_bits: np.ndarray,
                    pair_end: bool) -> None:
        """token: the submit_chain token of the batch just processed by
        the host; fast_bits: admitted fast reads (unique-mapped AND
        passed the host-side duplicate gate)."""
        pd_dev, mmp_dev, rl_dev = token[6], token[7], token[8]
        B = int(rl_dev.shape[0])
        kern = build_apply_kernel(self.L, self.two_l, B, bool(pair_end))
        fb = np.zeros((B + 31) // 32, dtype=np.int32)
        fb[:fast_bits.size] = fast_bits.view(np.int32)
        if pd_dev.dtype == jnp.int64:   # big-genome x64 path
            import jax
            with jax.enable_x64(True):
                self.planes = kern(self.planes, pd_dev, mmp_dev, rl_dev,
                                   jnp.asarray(fb))
            return
        self.planes = kern(self.planes, pd_dev, mmp_dev, rl_dev,
                           jnp.asarray(fb))

    CORRECT_CAP = 1024

    def reconcile_batch(self, token, fast_bits: np.ndarray,
                        pair_end: bool) -> None:
        """Post-host step for a batch. Classic tokens (no fold) run the
        stand-alone apply. Folded tokens (submit_chain(evidence=...))
        already hold the speculative apply of every device-FAST read;
        here the host's rejects (dup-gate losers, oracle-spliced reads)
        are retracted sparsely — the common no-reject batch costs no
        device work at all. A tier rerun (token[1] swapped by
        collect_chain) densely undoes the stale speculation and falls
        back to the classic apply with the rerun's outputs."""
        if len(token) <= 9:
            return self.apply_batch(token, fast_bits, pair_end)
        from ..ops.chain_device import CLASS_FAST
        dev0, pd0, mmp0 = token[9]
        rl_dev = token[8]
        B = int(rl_dev.shape[0])
        pe = bool(pair_end)
        if token[1] is not dev0:   # tier rerun invalidated the speculation
            undo = build_apply_kernel(self.L, self.two_l, B, pe,
                                      source="meta", sign=-1)
            self.planes = undo(self.planes, pd0, mmp0, rl_dev, dev0)
            return self.apply_batch(token, fast_bits, pair_end)
        meta = np.asarray(dev0)[:B]
        fast_ix = np.nonzero((meta & 3) == CLASS_FAST)[0]
        fb = np.zeros((B + 31) // 32, dtype=np.uint32)
        fb[:fast_bits.size] = fast_bits.view(np.uint32)
        admitted = ((fb[fast_ix >> 5] >> (fast_ix & 31)) & 1) == 1
        rej = fast_ix[~admitted].astype(np.int32)
        if rej.size == 0:
            return
        if rej.size > self.CORRECT_CAP:   # pathological: redo densely
            undo = build_apply_kernel(self.L, self.two_l, B, pe,
                                      source="meta", sign=-1)
            self.planes = undo(self.planes, pd0, mmp0, rl_dev, dev0)
            return self.apply_batch(token, fast_bits, pair_end)
        R = self.CORRECT_CAP
        rej_pad = np.full(R, B, dtype=np.int32)
        rej_pad[:rej.size] = rej
        kern = build_correct_kernel(self.L, self.two_l, B, pe, R)
        self.planes = kern(self.planes, token[6], token[7], rl_dev,
                           jnp.asarray(rej_pad))

    # ------------------------------------------------------------------
    def _ref_codes_dev(self):
        """Forward-genome codes [L] derived from the device text words."""
        ctx = self.be.chain_ctx
        L = self.L
        nw = (L + 15) // 16
        words = ctx.text_words[:nw]
        sh = jnp.asarray(((15 - (np.arange(16) & 15)) * 2).astype(np.uint32))
        crumbs = ((words[:, None] >> sh[None, :]) & 3).astype(jnp.int32)
        return crumbs.reshape(-1)[:L]

    def _merge_host_deltas(self) -> None:
        """Scatter the host profile's slow-read evidence (sparse nonzero
        diff entries + point adds) into the device planes, once."""
        p = self.host_profile
        L = self.L
        if (hasattr(p, "any_host_evidence")
                and not p.any_host_evidence()):
            # no host-side evidence this run (all reads applied on
            # device): skip eight O(L) nonzero scans + a merge dispatch
            return

        def nz(arr, base, width):
            a = np.asarray(arr).reshape(-1)
            idx = np.nonzero(a)[0]
            return idx.astype(np.int32), a[idx].astype(np.int32)

        ia, va = nz(p.acgt, 0, 0)
        # host acgt is [4, L]; device flat stride is L+1
        ia = (ia // L) * (L + 1) + (ia % L)
        ie, ve = nz(p.exact_diff, 0, 0)
        fparts = []
        for k, name in enumerate(("F1_diff", "R2_diff", "F2_diff",
                                  "R1_diff")):
            i, v = nz(getattr(p, name), 0, 0)
            fparts.append((i + k * (L + 2), v))
        if_ = np.concatenate([x[0] for x in fparts])
        vf = np.concatenate([x[1] for x in fparts])
        im, vm = nz(p.multi_diff, 0, 0)

        def tier(n):
            return next(t for t in self.MERGE_TIERS if t >= max(n, 1))

        Na, Ne, Nf, Nm = (tier(ia.size), tier(ie.size), tier(if_.size),
                          tier(im.size))
        kern = build_host_merge_kernel(L, Na, Ne, Nf, Nm)
        self.planes = kern(
            self.planes,
            jnp.asarray(_pad(ia, Na)), jnp.asarray(_pad(va, Na)),
            jnp.int32(ia.size),
            jnp.asarray(_pad(ie, Ne)), jnp.asarray(_pad(ve, Ne)),
            jnp.int32(ie.size),
            jnp.asarray(_pad(if_, Nf)), jnp.asarray(_pad(vf, Nf)),
            jnp.int32(if_.size),
            jnp.asarray(_pad(im, Nm)), jnp.asarray(_pad(vm, Nm)),
            jnp.int32(im.size))
        # zero the host-side copies so a later download doesn't double-add
        p.acgt[:] = 0
        p.exact_diff[:] = 0
        for name in ("F1_diff", "R2_diff", "F2_diff", "R1_diff",
                     "multi_diff"):
            getattr(p, name)[:] = 0

    def finalize(self):
        """Merge host deltas + fold diffs on device ->
        (acgt, F, multi, cov, cov_prefix), all device-resident."""
        if self._final is None:
            self._merge_host_deltas()
            kern = build_finalize_kernel(self.L)
            self._final = kern(self.planes, self._ref_codes_dev())
        return self._final

    def start_scan(self):
        """Dispatch the finalize+scan kernels and START the speculative
        D2H transfer without blocking on it. Call as soon as the
        evidence is complete (engine.finalize entry): the ~50 ms link
        round trip then overlaps the host-side post-mapping work
        (stats, INV/TNL sorts, breakpoint clustering, event-map prep)
        instead of serializing in front of it (the divergent-row
        residual VERDICT r4 weak #3 measured as ~4 such latencies)."""
        if self._scan is not None or self._scan_pending is not None:
            return
        from ..calling.scan_device import build_scan_kernel
        acgt, F, multi, cov, cov_prefix = self.finalize()
        kern = build_scan_kernel(self.L, bool(self.cfg.somatic))
        freq_base = 0.01 if self.cfg.somatic else self.cfg.frequency_thr
        bd, cand_idx, run_start, run_val, small = kern(
            acgt, multi, cov, self._ref_codes_dev(),
            jnp.int32(self.cfg.min_allele_depth), jnp.float32(freq_base))
        # ONE speculative D2H round trip: counts/partials plus a fixed
        # prefix of the cand/run tables ride one transfer (~80 KB ~ 3 ms
        # payload vs ~50 ms/transfer link latency); only runs whose
        # tables overflow the speculative prefix pay a second bucketed
        # pull (the capacity-padded arrays are 8.5 MB — never pull whole)
        K1S = min(4096, cand_idx.shape[0])
        K2S = min(8192, run_start.shape[0])
        spec = jnp.concatenate(
            [small.astype(jnp.int32), cand_idx[:K1S], run_start[:K2S],
             run_val[:K2S]])
        try:
            spec.copy_to_host_async()
        except Exception:
            pass
        self._scan_pending = (bd, cand_idx, run_start, run_val,
                              small.shape[0], K1S, K2S, spec)

    def scan(self):
        """Dense caller scan (cached); returns
        (block_depth LazyBlockDepth — device-resident, sparse host
        access, cand_idx, run_start, run_val,
        scalars int64[4] = (n_cand, n_runs, n_aligned, total_cov))."""
        if self._scan is not None:
            return self._scan
        from ..calling.scan_device import (BLOCK_SIZE, LazyBlockDepth,
                                           unpack_small)
        self.start_scan()
        (bd, cand_idx, run_start, run_val, ns, K1S, K2S,
         spec_dev) = self._scan_pending
        self._scan_pending = None
        spec = np.asarray(spec_dev)
        n_cand, n_runs, n_aligned, total_cov = unpack_small(spec[:ns])
        scal4 = np.array([n_cand, n_runs, n_aligned, total_cov], np.int64)
        k1 = _bucket(n_cand, cand_idx.shape[0])
        k2 = _bucket(n_runs, run_start.shape[0])
        if n_cand <= K1S and n_runs <= K2S:
            k1, k2 = K1S, K2S
            packed = spec[ns:]
        else:
            packed = np.asarray(jnp.concatenate(
                [cand_idx[:k1], run_start[:k2], run_val[:k2]]))
        nb = (self.L + BLOCK_SIZE - 1) // BLOCK_SIZE
        self._scan = (LazyBlockDepth(bd, nb), packed[:k1],
                      packed[k1:k1 + k2], packed[k1 + k2:], scal4)
        return self._scan

    def fetch_columns(self, positions: np.ndarray, prefix_pts: np.ndarray,
                      bd_blocks: np.ndarray = None):
        """Gather evidence columns + cov-prefix values (one packed D2H).
        When bd_blocks is given and scan() has run, the block-depth
        values at those blocks ride the same transfer and seed the
        LazyBlockDepth cache."""
        from ..calling.scan_device import build_fetch_kernel
        acgt, F, multi, cov, cov_prefix = self.finalize()
        kern = build_fetch_kernel(self.L)
        cols, pref = kern(acgt, multi, F, cov, cov_prefix,
                          jnp.asarray(positions.astype(np.int32)),
                          jnp.asarray(prefix_pts.astype(np.int32)))
        parts = [cols.reshape(-1).astype(pref.dtype), pref]
        nbd = 0
        if bd_blocks is not None and self._scan is not None:
            lbd = self._scan[0]
            bd_blocks = np.unique(bd_blocks)
            bd_blocks = bd_blocks[(bd_blocks >= 0) & (bd_blocks < lbd.nb)]
            nbd = bd_blocks.size
            if nbd:
                parts.append(jnp.take(
                    lbd._arr, jnp.asarray(bd_blocks.astype(np.int32))
                ).astype(pref.dtype))
        packed = np.asarray(jnp.concatenate(parts))
        nc = cols.shape[0] * cols.shape[1]
        cols_h = packed[:nc].reshape(cols.shape)
        pref_h = packed[nc:nc + pref.shape[0]]
        if nbd:
            self._scan[0].insert(bd_blocks, packed[nc + pref.shape[0]:])
        return cols_h, pref_h

    def nor_blocks(self, emitted: np.ndarray, brk: np.ndarray):
        """gVCF NOR-block reduction on the device planes: returns
        (first_pos, min_cov, cov_at_first) per block key. emitted =
        positions whose own record excludes them from 'normal'; brk =
        every record-appending position (sorted)."""
        from ..calling.scan_device import NOR_SEG_TIERS, build_nor_kernel
        acgt, F, multi, cov, cov_prefix = self.finalize()
        NSEG = next(t for t in NOR_SEG_TIERS if t > brk.size + 1)
        kern = build_nor_kernel(self.L, NSEG)
        em = np.full(max(emitted.size, 1), -1, dtype=np.int32)
        em[:emitted.size] = emitted
        bk = np.full(max(brk.size, 1), self.L, dtype=np.int32)
        bk[:brk.size] = np.sort(brk)
        first, mincov, covf = kern(cov, jnp.asarray(em),
                                   jnp.int32(emitted.size),
                                   jnp.asarray(bk), jnp.int32(brk.size))
        packed = np.asarray(jnp.concatenate([first, mincov, covf]))
        k = first.shape[0]
        return packed[:k], packed[k:2 * k], packed[2 * k:]

    def download_raw_into(self, profile) -> None:
        """Add the device planes' raw (unfolded, uncapped) contributions
        into the host profile's diff arrays — for merge_engines and the
        gVCF/monomorphic/observe fallbacks, so saturation happens once
        on the final fold. Costs one genome-sized D2H."""
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

    def download_into(self, profile) -> None:
        """Fallback path: fold everything into the host Profile arrays
        (profile.finalize_diffs completes the fold on host)."""
        self.download_raw_into(profile)
