"""Device-side variant-caller scan over the HBM-resident evidence
planes (ref: src/VariantCalling.cpp:106-120 block depth, :550-680 scan).

The genome-axis math runs on device; only sparse results cross the
link: SUB candidate indices (a conservative superset of the host
threshold — exact float64 thresholds re-applied on host), gap/CNV run
boundaries, and exact int64-safe scalar reductions.  The per-100bp
block-depth array stays DEVICE-resident (LazyBlockDepth): every host
consumer indexes it only at sparse positions (indel keys, breakpoint
candidates — device_call.py, caller.identify_sv), so downloading it
densely would cost O(GenomeSize/100) D2H (~124 MB at human scale) for
a handful of values.
A second call gathers full evidence columns (acgt / multi / read_count
/ F planes / cov / cov prefix) at the sparse positions every downstream
consumer (record emission, VCF writer, SV scoring) reads.
"""
from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

BLOCK_SIZE = 100
CAND_CAP = 1 << 17
RUN_CAP = 1 << 20
# blocks per device-side partial sum of the hi/lo coverage planes.
# int32 safety: per-block blk_hi <= (4*4095>>8)*100 = 6300 and
# blk_lo <= 255*100 = 25500, so a 4096-block partial tops out at
# 25.8M / 104M — far below 2^31; the host finishes in int64.
BLK_PART = 4096


class LazyBlockDepth:
    """Device-resident per-100bp block depths with sparse host access.

    The dense array (GenomeSize/100 entries) is only ever indexed at a
    handful of sparse positions host-side (ref: VariantCalling.cpp uses
    BlockDepthArr at indel/breakpoint loci, :576-597 and :229-282), so
    it stays on device; ``prefetch`` batches one gather for a block
    set, ``__getitem__`` serves cached values (gathering one-off on a
    miss), and ``dense()``/``astype`` materialize the full array for
    tests and fallback paths."""

    def __init__(self, arr, nb: int):
        self._arr = arr            # jax int32 device array, len >= nb
        self.nb = nb
        self._cache: Dict[int, int] = {}
        self._dense = None

    def prefetch(self, blocks) -> None:
        if self._dense is not None:
            return
        blocks = np.unique(np.asarray(blocks, dtype=np.int64))
        blocks = blocks[(blocks >= 0) & (blocks < self.nb)]
        missing = [int(b) for b in blocks.tolist() if b not in self._cache]
        if not missing:
            return
        vals = np.asarray(jnp.take(
            self._arr, jnp.asarray(np.asarray(missing, np.int32))))
        self._cache.update(zip(missing, (int(v) for v in vals)))

    def insert(self, blocks, vals) -> None:
        """Seed the cache with externally-gathered values (fetched on a
        shared transfer, see DeviceEvidence.fetch_columns)."""
        self._cache.update(zip((int(b) for b in np.asarray(blocks)),
                               (int(v) for v in np.asarray(vals))))

    def __getitem__(self, b) -> int:
        b = int(b)
        if self._dense is not None:
            return int(self._dense[b])
        if b not in self._cache:
            if not 0 <= b < self.nb:
                raise IndexError(b)
            self.prefetch(np.asarray([b]))
        return self._cache[b]

    def dense(self) -> np.ndarray:
        if self._dense is None:
            self._dense = np.asarray(self._arr)[:self.nb].astype(np.int64)
        return self._dense

    def astype(self, dtype) -> np.ndarray:
        return self.dense().astype(dtype)

    def __len__(self) -> int:
        return self.nb


@functools.lru_cache(maxsize=None)
def build_scan_kernel(L: int, somatic: bool):
    nb = (L + BLOCK_SIZE - 1) // BLOCK_SIZE

    def kernel(acgt, multi, cov, ref_codes, min_allele_depth,
               freq_base):
        pad = nb * BLOCK_SIZE - L
        covp = jnp.concatenate([cov, jnp.zeros(pad, jnp.int32)])
        sums = covp.reshape(nb, BLOCK_SIZE).sum(axis=1)
        block_depth = jnp.where(sums > 0, sums // BLOCK_SIZE, 0)

        ad = min_allele_depth
        if somatic:
            cov_thr = jnp.full(L, ad, jnp.int32)
        else:
            bd_pos = jnp.repeat(block_depth, BLOCK_SIZE,
                                total_repeat_length=nb * BLOCK_SIZE)[:L]
            cov_thr = jnp.maximum(bd_pos >> 1, ad)
        rc = ref_codes[:L]
        nonref_max = jnp.full(L, -1, jnp.int32)
        for c in range(4):
            nonref_max = jnp.maximum(
                nonref_max, jnp.where(rc == c, -1, acgt[c]))
        # conservative superset of max(ceil_f64(cov*freq_base), ad):
        # f32 product minus 1 covers rounding differences
        sup_thr = jnp.maximum(
            (cov.astype(jnp.float32) * freq_base).astype(jnp.int32) - 1, ad)
        cand_mask = (cov >= cov_thr) & (nonref_max >= sup_thr)
        dest = jnp.cumsum(cand_mask.astype(jnp.int32)) - 1
        n_cand = jnp.where(cand_mask, dest + 1, 0).max()
        pos = jnp.arange(L, dtype=jnp.int32)
        cand_idx = jnp.full(CAND_CAP + 1, -1, jnp.int32).at[
            jnp.where(cand_mask, jnp.minimum(dest, CAND_CAP), CAND_CAP)].set(
            pos, mode="drop")[:CAND_CAP]

        # gap/CNV run boundaries (ref: cpp:632-651 semantics done on host)
        state = jnp.where(cov > 0, 2,
                          jnp.where(multi > 0, 1, 0)).astype(jnp.int32)
        newrun = jnp.concatenate([jnp.ones(1, bool), state[1:] != state[:-1]])
        rdest = jnp.cumsum(newrun.astype(jnp.int32)) - 1
        n_runs = rdest[-1] + 1
        run_start = jnp.full(RUN_CAP + 1, -1, jnp.int32).at[
            jnp.where(newrun, jnp.minimum(rdest, RUN_CAP), RUN_CAP)].set(
            pos, mode="drop")[:RUN_CAP]
        run_val = jnp.zeros(RUN_CAP + 1, jnp.int32).at[
            jnp.where(newrun, jnp.minimum(rdest, RUN_CAP), RUN_CAP)].set(
            state, mode="drop")[:RUN_CAP]

        aligned = cov > 0
        n_aligned = aligned.sum()
        # coverage total split into hi/lo bytes, reduced on device to
        # BLK_PART-block int32 partials (each provably < 2^31); the host
        # finishes in int64 — a single int32 total overflows once aligned
        # low-byte coverage exceeds 2^31 at chromosome scale, and dense
        # per-block downloads cost O(L/100) D2H for one scalar
        alignedp = jnp.concatenate([aligned, jnp.zeros(pad, bool)])
        blk_hi = jnp.where(alignedp, covp >> 8, 0).reshape(
            nb, BLOCK_SIZE).sum(axis=1)
        blk_lo = jnp.where(alignedp, covp & 255, 0).reshape(
            nb, BLOCK_SIZE).sum(axis=1)
        npart = (nb + BLK_PART - 1) // BLK_PART
        padb = npart * BLK_PART - nb
        hi_part = jnp.concatenate([blk_hi, jnp.zeros(padb, blk_hi.dtype)]
                                  ).reshape(npart, BLK_PART).sum(axis=1)
        lo_part = jnp.concatenate([blk_lo, jnp.zeros(padb, blk_lo.dtype)]
                                  ).reshape(npart, BLK_PART).sum(axis=1)
        # ONE host-bound array for every scalar-sized result: per-
        # transfer latency dominates small D2H, so the
        # counts and the coverage partials ride one round trip
        small = jnp.concatenate(
            [jnp.stack([n_cand, n_runs, n_aligned]), hi_part, lo_part])
        return block_depth, cand_idx, run_start, run_val, small

    return jax.jit(kernel)


def unpack_small(small: np.ndarray):
    """Split the scan kernel's packed small array -> int64
    (n_cand, n_runs, n_aligned, total_cov)."""
    npart = (small.size - 3) // 2
    hi = small[3:3 + npart].astype(np.int64)
    lo = small[3 + npart:].astype(np.int64)
    total_cov = (int(hi.sum()) << 8) + int(lo.sum())
    return (int(small[0]), int(small[1]), int(small[2]), total_cov)


@functools.lru_cache(maxsize=None)
def build_fetch_kernel(L: int):
    """Gather evidence columns at sparse positions: returns
    [P, 10] = (A, C, G, T, multi, F1, R2, F2, R1, cov)
    plus cov_prefix values at a second position list."""

    def kernel(acgt, multi, F, cov, cov_prefix, positions, prefix_pts):
        p = jnp.clip(positions, 0, L - 1)
        cols = jnp.stack([acgt[0][p], acgt[1][p], acgt[2][p], acgt[3][p],
                          multi[p],
                          F[0][p], F[1][p], F[2][p], F[3][p], cov[p]],
                         axis=1)
        pref = cov_prefix[jnp.clip(prefix_pts, 0, L)]
        return cols, pref

    return jax.jit(kernel)


class _SparseVec:
    """1-D plane view backed by fetched columns; fails fast on
    positions outside the fetched set."""

    def __init__(self, cols: Dict[int, np.ndarray], k: int):
        self._cols = cols
        self._k = k

    def __getitem__(self, g):
        return int(self._cols[int(g)][self._k])


class _SparseAcgt:
    def __init__(self, cols: Dict[int, np.ndarray]):
        self._cols = cols

    def __getitem__(self, key):
        k, g = key
        col = self._cols[int(g)]
        if isinstance(k, slice):
            return col[:4]
        return int(col[k])


class SparseProfile:
    """Duck-typed stand-in for pipeline.profile.Profile when the planes
    live on device: every consumer reads either host-side event dicts or
    evidence columns fetched for the sparse position set."""

    def __init__(self, host_profile, cols: Dict[int, np.ndarray],
                 cov_prefix: Dict[int, int], genome_size: int):
        self.n = genome_size
        self._cols = cols
        self._cov_prefix = cov_prefix
        self.insert_map = host_profile.insert_map
        self.delete_map = host_profile.delete_map
        self.break_point = host_profile.break_point
        # the duplicate-gate counter stays host-authoritative (dense)
        self.read_count = host_profile.read_count
        self.acgt = _SparseAcgt(cols)
        self.multi_hit = _SparseVec(cols, 4)
        self.F1 = _SparseVec(cols, 5)
        self.R2 = _SparseVec(cols, 6)
        self.F2 = _SparseVec(cols, 7)
        self.R1 = _SparseVec(cols, 8)

    def column_size(self, g_pos: int) -> int:
        return int(self._cols[int(g_pos)][9])

    def region_cov_sum(self, beg: int, end: int) -> int:
        """sum(cov[beg:end+1]) from device prefix sums."""
        return self._cov_prefix[end + 1] - self._cov_prefix[beg]


NOR_SEG_TIERS = (1 << 12, 1 << 15, 1 << 18, 1 << 21)


@functools.lru_cache(maxsize=None)
def build_nor_kernel(L: int, NSEG: int):
    """gVCF NOR-block reduction on device (ref: VariantCalling.cpp:
    652-661 via the RLE formulation of caller._identify_variants_gvcf_vec):
    normal positions (covered, no record emitted there) group by
    key[p] = #record-appending positions <= p; per group the record is
    (first normal position, cov at it, min cov over the group).

    Inputs: cov [L]; emitted positions (sparse, padded, -1 pad) whose
    own position is excluded from 'normal'; brk positions (sparse,
    padded: every record-appending position incl. run flushes).
    Outputs per segment: (first_pos or -1, min_cov)."""

    def kernel(cov, emitted, n_emitted, brk_sorted, n_brk):
        pos = jnp.arange(L, dtype=jnp.int32)
        em_mask = jnp.zeros(L + 1, bool).at[
            jnp.where(jnp.arange(emitted.shape[0]) < n_emitted,
                      jnp.clip(emitted, 0, L - 1), L)].set(
            True, mode="drop")[:L]
        normal = (cov > 0) & ~em_mask
        # key[p] = # brk positions <= p  (brk_sorted padded with L+1)
        key = jnp.searchsorted(brk_sorted, pos, side="right").astype(jnp.int32)
        seg = jnp.where(normal, jnp.minimum(key, NSEG - 1), NSEG - 1)
        BIG = jnp.int32(0x7FFFFFFF)
        first = jax.ops.segment_min(jnp.where(normal, pos, BIG), seg,
                                    num_segments=NSEG)
        mincov = jax.ops.segment_min(jnp.where(normal, cov, BIG), seg,
                                     num_segments=NSEG)
        covf = cov[jnp.clip(first, 0, L - 1)]   # DP = cov at block start
        return first, mincov, covf

    return jax.jit(kernel)
