"""Device-resident FM-index and batched Occ primitives (JAX).

Accelerator-first re-design of the reference's occ machinery
(ref: src/bwt_search.cpp:8-119). The reference interleaves 4x uint64
checkpoints every 128 bases with the packed BWT; on the device the expensive
resource is random-gather count, so we precompute occ at EVERY 16-base
word and interleave [cntA, cntC, cntG, cntT, word, 0, 0, 0] into one
int32[8] row (32 B, one aligned gather per occ query). Byte-LUT
popcounts (__occ_aux4 / cnt_table) become `lax.population_count` on
2-bit-crumb equality masks.

Memory: 2 bytes per text base (E. coli ~18 MB, human fwd+rc ~12 GB —
larger genomes switch to 32-base rows and/or genome sharding, see
parallel/).

All row indices fit int32 for genomes up to ~1 Gbp (2 Gbp fwd+rc text).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..index.fmindex import FMIndex


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class DeviceFMIndex:
    occ_rows: jnp.ndarray     # int32[nw+1, 8]: occ@word-start x4, word, pad
    L2: jnp.ndarray           # int32[5]
    sa_samp: jnp.ndarray      # int32[ns]
    sa_full: jnp.ndarray      # int32[n+1] or int32[0] when absent
    primary: int              # static
    seq_len: int              # static
    genome_size: int          # static

    @property
    def has_full_sa(self) -> bool:
        return self.sa_full.shape[0] > 0

    def tree_flatten(self):
        return ((self.occ_rows, self.L2, self.sa_samp, self.sa_full),
                (self.primary, self.seq_len, self.genome_size))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @classmethod
    def from_host(cls, idx: FMIndex,
                  sa_budget_bytes: int = 2 << 30) -> "DeviceFMIndex":
        """sa_budget_bytes: keep the full SA in HBM (one gather per hit)
        only below this size; above it the sampled-SA inverse-Psi walk
        (sa_resolve fallback) is the default — human-scale fwd+rc texts
        would need ~25 GB of HBM for the full SA."""
        if idx.seq_len >= 2**31:
            # host index build supports int64 (mc_build_suffix_array64);
            # the DEVICE rows stay int32 — >1 Gbp genomes take the
            # genome-sharded mesh path (parallel/), not a single chip
            raise NotImplementedError(
                "single-chip device index is int32 (text < 2^31); "
                "shard the genome over the mesh for larger references")
        n = idx.seq_len
        nw = (n + 15) // 16
        rows = np.zeros((nw + 1, 8), dtype=np.int64)
        # per-word occ via vectorized crumb expansion
        words = np.zeros(nw, dtype=np.uint32)
        words[:] = idx.bwt_words[:nw]
        shifts = (np.arange(15, -1, -1, dtype=np.uint32) << 1)
        crumbs = (words[:, None] >> shifts[None, :]) & 3       # [nw,16]
        # crumbs beyond n are pad zeros; exclude them from counts
        valid = (np.arange(nw)[:, None] * 16 + np.arange(16)[None, :]) < n
        for c in range(4):
            cnt = ((crumbs == c) & valid).sum(axis=1)
            cum = np.zeros(nw + 1, dtype=np.int64)
            np.cumsum(cnt, out=cum[1:])
            rows[:, c] = cum
        rows[:nw, 4] = words.astype(np.int64)
        assert rows[:, :4].max() < 2**31
        rows32 = rows.astype(np.int32)
        keep_full_sa = (idx.sa_full is not None
                        and idx.sa_full.nbytes <= sa_budget_bytes)
        sa_full = (idx.sa_full if keep_full_sa
                   else np.zeros(0, dtype=np.int32))
        return cls(
            occ_rows=jnp.asarray(rows32),
            L2=jnp.asarray(idx.L2, dtype=jnp.int32),
            sa_samp=jnp.asarray(idx.sa_samp, dtype=jnp.int32),
            sa_full=jnp.asarray(sa_full, dtype=jnp.int32),
            primary=int(idx.primary),
            seq_len=int(idx.seq_len),
            genome_size=int(idx.genome_size),
        )


def _partial_counts(word: jnp.ndarray, kadj: jnp.ndarray) -> jnp.ndarray:
    """Counts of each base among the first (kadj%16)+1 crumbs of `word`
    (big-end crumb order). word: uint32[B] -> int32[B,4]."""
    crumb = (~kadj) & 0xF
    keep = (~((jnp.uint32(1) << (2 * crumb).astype(jnp.uint32)) - jnp.uint32(1))
            ) & jnp.uint32(0x55555555)
    outs = []
    for c in range(4):
        x = word ^ jnp.uint32(c * 0x55555555)
        nx = ~x
        m = nx & (nx >> 1) & keep
        outs.append(jax.lax.population_count(m).astype(jnp.int32))
    return jnp.stack(outs, axis=-1)


def occ4(fm: DeviceFMIndex, k: jnp.ndarray) -> jnp.ndarray:
    """Batched bwt_occ4 (ref: bwt_search.cpp:49-66): counts of each base
    in BWT rows [0, k]; k == -1 gives zeros. k: int32[...] -> int32[...,4].
    One 32-byte row gather per query."""
    neg = k < 0
    ksafe = jnp.where(neg, 0, k)
    kadj = ksafe - (ksafe >= fm.primary).astype(ksafe.dtype)
    row = fm.occ_rows[kadj >> 4]                        # [...,8]
    word = jax.lax.bitcast_convert_type(row[..., 4], jnp.uint32)
    cnt = row[..., :4] + _partial_counts(word, kadj)
    return jnp.where(neg[..., None], 0, cnt)


def occ_one(fm: DeviceFMIndex, k: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """Batched bwt_occ for per-row base c (ref: bwt_search.cpp:25-47)."""
    is_full = k == fm.seq_len
    neg = k < 0
    ksafe = jnp.where(neg | is_full, 0, k)
    kadj = ksafe - (ksafe >= fm.primary).astype(ksafe.dtype)
    row = fm.occ_rows[kadj >> 4]
    word = jax.lax.bitcast_convert_type(row[..., 4], jnp.uint32)
    base = jnp.take_along_axis(row[..., :4], c[..., None].astype(jnp.int32),
                               axis=-1)[..., 0]
    crumb = (~kadj) & 0xF
    keep = (~((jnp.uint32(1) << (2 * crumb).astype(jnp.uint32)) - jnp.uint32(1))
            ) & jnp.uint32(0x55555555)
    x = word ^ (c.astype(jnp.uint32) * jnp.uint32(0x55555555))
    nx = ~x
    m = nx & (nx >> 1) & keep
    n = base + jax.lax.population_count(m).astype(jnp.int32)
    full_val = fm.L2[c + 1] - fm.L2[c]
    return jnp.where(is_full, full_val, jnp.where(neg, 0, n))


def inv_psi(fm: DeviceFMIndex, k: jnp.ndarray) -> jnp.ndarray:
    """Batched LF step (ref: bwt_search.cpp:101-107). One row gather:
    the adjusted indices x = k - (k > primary) and kadj = k - (k >=
    primary) coincide except at k == primary, whose result is discarded,
    so one row serves both the BWT-code read and the occ count."""
    kadj = k - (k >= fm.primary).astype(k.dtype)
    row = fm.occ_rows[kadj >> 4]
    word = jax.lax.bitcast_convert_type(row[..., 4], jnp.uint32)
    c = ((word >> (((~kadj & 0xF) << 1)).astype(jnp.uint32)) & 3).astype(jnp.int32)
    base = jnp.take_along_axis(row[..., :4], c[..., None], axis=-1)[..., 0]
    crumb = (~kadj) & 0xF
    keep = (~((jnp.uint32(1) << (2 * crumb).astype(jnp.uint32)) - jnp.uint32(1))
            ) & jnp.uint32(0x55555555)
    xw = word ^ (c.astype(jnp.uint32) * jnp.uint32(0x55555555))
    nx = ~xw
    m = nx & (nx >> 1) & keep
    occ_kc = base + jax.lax.population_count(m).astype(jnp.int32)
    val = fm.L2[c] + occ_kc
    return jnp.where(k == fm.primary, 0, val)


def sa_resolve(fm: DeviceFMIndex, k: jnp.ndarray, active: jnp.ndarray,
               max_walk: int = 192):
    """Batched bwt_sa (ref: bwt_search.cpp:109-119).

    Fast path (genome small enough to keep the full SA in HBM at
    4 B/base): one gather, exact. Fallback: lockstep inverse-Psi walk
    until every active row index is a multiple of 32 — the walk length
    is geometric with mean 32 (bwa samples by ROW index, bwt.c:118-121),
    so a fixed `max_walk`-step fori_loop resolves all but ~(31/32)^192
    ~= 0.2%% of rows; unresolved lanes are flagged for host fallback.
    Returns (loc int32[B], resolved bool[B])."""
    if fm.has_full_sa:
        return fm.sa_full[k], jnp.ones_like(k, dtype=bool) & active

    def body(_, state):
        k_, steps_ = state
        todo = active & ((k_ & 31) != 0)
        k_new = inv_psi(fm, jnp.where(todo, k_, 32))
        k_ = jnp.where(todo, k_new, k_)
        steps_ = jnp.where(todo, steps_ + 1, steps_)
        return k_, steps_

    steps = jnp.zeros_like(k)
    k_f, steps_f = jax.lax.fori_loop(0, max_walk, body, (k, steps))
    resolved = active & ((k_f & 31) == 0)
    return steps_f + fm.sa_samp[k_f >> 5], resolved
