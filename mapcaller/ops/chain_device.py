"""Device chaining + fast-path classification.

After seeding, the reference chains seeds by diagonal, aligns, and
accumulates evidence on the CPU (ref: src/ReadMapping.cpp:194-226
SimplePairClustering, src/ReadAlignment.cpp:306-430). Here we
classify each read right after SA resolution, entirely on device:

  FAST   — every kept hit lies on ONE diagonal pd, the single cluster
           passes the score threshold, the whole span [pd, pd+rlen)
           stays inside one chromosome block, and every uncovered gap
           along the diagonal is identity-alignable: the gapped-DP
           trigger of ProcessNormalPair (ref: ReadAlignment.cpp:184-188,
           mis > 1 && mis >= int(len*0.2), with int(n*0.2) == n//5
           exactly) fires for NO gap. For such reads the host needs only
           (pd, mismatch count, last-block start, cluster score) — the
           alignment outcome is provably the identity along pd, so
           seeds never leave the device.
  NOCAND — no kept hits, or the single-diagonal cluster fails
           score > rlen/4: the host would produce zero candidates.
  SLOW   — everything else (multi-diagonal, indels, repeats with > K
           hits, boundary-crossing, DP-triggering gaps): hits are
           compacted and downloaded for the host pipeline, exactly as
           before.

The head/tail quality vetoes (ref: ReadAlignment.cpp:193-232) cannot
fire on a read passing the gap conditions: mg >= 3 && mg >= int(0.3*lg)
contradicts NOT(mg > 1 && mg >= int(0.2*lg)).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

K_HITS = 8          # per-read hit window; more => slow path
MAX_GAPS = 10       # K_HITS + head + tail
MM_SLOTS = 4        # mismatch positions carried for device evidence
CLASS_NOCAND = 0
CLASS_FAST = 1
CLASS_SLOW = 2


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class ChainCtx:
    text_words: jnp.ndarray    # uint32[nw+1]: packed 2-bit text, bwa order
    bkeys: jnp.ndarray         # int32[nb]: sorted chrom end positions (2L pad)
    seq_len: int               # 2L

    def tree_flatten(self):
        return ((self.text_words, self.bkeys), (self.seq_len,))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @classmethod
    def from_host(cls, idx) -> "ChainCtx":
        from ..index.fmindex import pack_words
        text = idx.ref.fwd_rc_codes()
        words = pack_words(text)
        words = np.concatenate([words, np.zeros(2, dtype=np.uint32)])
        genome = idx.ref
        # chrom end positions, both strands (mirrors Ctx.bkeys in C++)
        L = idx.genome_size
        two_l = idx.seq_len
        keys = []
        for off, ln in zip(genome.offsets, genome.lengths):
            keys.append(off + ln)
        for off, ln in zip(reversed(genome.offsets), reversed(genome.lengths)):
            keys.append(two_l - off)
        keys = sorted(keys)
        return cls(text_words=jnp.asarray(words),
                   bkeys=jnp.asarray(np.asarray(keys, dtype=np.int32)),
                   seq_len=int(two_l))


def _sort_slots(pd, rpos, ln):
    """Bitonic-free odd-even transposition sort over the K_HITS axis by
    (pd, rpos); empty slots carry pd = INT32_MAX and sink to the end."""
    K = pd.shape[-1]
    for phase in range(K):
        start = phase & 1
        for i in range(start, K - 1, 2):
            a_pd, b_pd = pd[..., i], pd[..., i + 1]
            a_rp, b_rp = rpos[..., i], rpos[..., i + 1]
            swap = (a_pd > b_pd) | ((a_pd == b_pd) & (a_rp > b_rp))
            new_i_pd = jnp.where(swap, b_pd, a_pd)
            new_j_pd = jnp.where(swap, a_pd, b_pd)
            new_i_rp = jnp.where(swap, b_rp, a_rp)
            new_j_rp = jnp.where(swap, a_rp, b_rp)
            a_ln, b_ln = ln[..., i], ln[..., i + 1]
            new_i_ln = jnp.where(swap, b_ln, a_ln)
            new_j_ln = jnp.where(swap, a_ln, b_ln)
            pd = pd.at[..., i].set(new_i_pd).at[..., i + 1].set(new_j_pd)
            rpos = rpos.at[..., i].set(new_i_rp).at[..., i + 1].set(new_j_rp)
            ln = ln.at[..., i].set(new_i_ln).at[..., i + 1].set(new_j_ln)
    return pd, rpos, ln


def classify_reads(ctx: ChainCtx, read_words: jnp.ndarray, rlens: jnp.ndarray,
                   hit_read, hit_rpos, hit_len, hit_loc, keep, max_len: int):
    """All inputs are flat hit arrays (grouped by read) + per-read data.
    Returns (cls int32[B], pd int32[B], mm int32[B], rplast int32[B],
    cscore int32[B]) with pd = the single diagonal for FAST reads."""
    B = read_words.shape[0]
    H = hit_read.shape[0]
    INT_MAX = jnp.int32(0x7FFFFFFF)
    # position dtype follows hit_loc: int32 on the standard path, int64
    # on the big-genome x64 path where diagonals exceed 2^31 (the
    # reference's coordinates are bwtint_t = uint64 end to end, ref:
    # src/BWT_Index/bwt.h:44)
    pdt = hit_loc.dtype
    PD_MAX = jnp.asarray(jnp.iinfo(pdt).max, dtype=pdt)

    # ---- scatter kept hits into per-read K-slot windows ------------------
    dest = jnp.cumsum(keep.astype(jnp.int32)) - 1
    first = jnp.full(B + 1, INT_MAX, jnp.int32).at[hit_read].min(
        jnp.where(keep, dest, INT_MAX), mode="drop")[:B]
    within = dest - first[jnp.clip(hit_read, 0, B - 1)]
    nkept = jnp.zeros(B, jnp.int32).at[hit_read].add(
        keep.astype(jnp.int32), mode="drop")
    ok_slot = keep & (within >= 0) & (within < K_HITS)
    row = jnp.where(ok_slot, hit_read, B)
    col = jnp.where(ok_slot, within, 0)
    pd_flat = hit_loc - hit_rpos.astype(pdt)
    s_pd = jnp.full((B + 1, K_HITS), PD_MAX, pdt).at[row, col].set(
        jnp.where(ok_slot, pd_flat, PD_MAX), mode="drop")[:B]
    s_rp = jnp.zeros((B + 1, K_HITS), jnp.int32).at[row, col].set(
        jnp.where(ok_slot, hit_rpos, 0), mode="drop")[:B]
    s_ln = jnp.zeros((B + 1, K_HITS), jnp.int32).at[row, col].set(
        jnp.where(ok_slot, hit_len, 0), mode="drop")[:B]
    s_pd, s_rp, s_ln = _sort_slots(s_pd, s_rp, s_ln)

    has_hits = nkept > 0
    too_many = nkept > K_HITS
    valid_slot = s_pd != PD_MAX
    pd0 = s_pd[:, 0]
    one_diag = (jnp.where(valid_slot, s_pd, pd0[:, None]) == pd0[:, None]
                ).all(axis=1)
    cscore = jnp.where(valid_slot, s_ln, 0).sum(axis=1)
    has_can = cscore > (rlens >> 2)

    # ---- chromosome containment of the full span [pd, pd+rlen) ----------
    span_ok = (pd0 + rlens) <= ctx.seq_len
    # lower_bound semantics, matching boundary_index / the reference's
    # PosChrIdMap lookups (tools.cpp:132-164)
    pdc = jnp.clip(pd0, 0, ctx.seq_len - 1)
    bkeys = ctx.bkeys.astype(pdt)
    b1 = jnp.searchsorted(bkeys, pdc, side="left")
    b2 = jnp.searchsorted(bkeys, jnp.clip(pd0 + rlens - 1, 0,
                                          ctx.seq_len - 1), side="left")
    span_ok = span_ok & (b1 == b2)

    # ---- diagonal mismatch mask ------------------------------------------
    nwords = read_words.shape[1]
    pds = jnp.where(span_ok & has_hits, pd0, 0)
    base_w = pds >> 4
    sh = ((pds & 15) * 2).astype(jnp.uint32)
    widx = jnp.arange(nwords + 1, dtype=jnp.int32)[None, :]
    tw = ctx.text_words[jnp.clip(base_w[:, None] + widx, 0,
                                 ctx.text_words.shape[0] - 1)]
    lo = jnp.where(sh[:, None] > 0,
                   (tw[:, 1:] >> (jnp.uint32(32) - sh[:, None])), 0)
    aligned = (tw[:, :-1] << sh[:, None]) | lo          # [B, nwords]
    x = aligned ^ read_words
    y = (x | (x >> 1)) & jnp.uint32(0x55555555)         # crumb-mismatch bits
    jpos = np.arange(max_len, dtype=np.int32)
    wsel = jpos >> 4
    bit = ((15 - (jpos & 15)) * 2).astype(np.uint32)
    mmask = ((y[:, wsel] >> jnp.asarray(bit)[None, :]) & 1).astype(jnp.int32)
    inlen = jpos[None, :] < rlens[:, None]
    mmask = mmask * inlen

    # ---- coverage mask + per-gap conditions ------------------------------
    cov = jnp.zeros((B, max_len), dtype=bool)
    for k in range(K_HITS):
        sk = jnp.where(s_pd[:, k] == pd0, s_rp[:, k], max_len)
        ek = sk + jnp.where(s_pd[:, k] == pd0, s_ln[:, k], 0)
        cov = cov | ((jpos[None, :] >= sk[:, None]) &
                     (jpos[None, :] < ek[:, None]))
    uncov = (~cov) & inlen
    gap_start = uncov & jnp.concatenate(
        [jnp.ones((B, 1), bool), cov[:, :-1]], axis=1)
    gapidx = jnp.cumsum(gap_start.astype(jnp.int32), axis=1) - 1
    dp_any = jnp.zeros(B, dtype=bool)
    for g in range(MAX_GAPS):
        mask_g = uncov & (gapidx == g)
        lg = mask_g.sum(axis=1)
        mg = (mask_g & (mmask > 0)).sum(axis=1)
        dp_any = dp_any | ((lg > 0) & (mg > 1) & (mg >= lg // 5))
    many_gaps = (uncov & (gapidx >= MAX_GAPS)).any(axis=1)
    mm_total = (mmask * uncov).sum(axis=1)

    # last alignment block start: tail gap start if the read end is
    # uncovered, else the last seed's rPos (feeds frags[0].gPos of
    # reverse-strand candidates, ref: SamReport.cpp:121-170)
    seed_end = jnp.where(valid_slot & (s_pd == pd0[:, None]),
                         s_rp + s_ln, 0).max(axis=1)
    seed_last_rp = jnp.where(valid_slot & (s_pd == pd0[:, None]),
                             s_rp, -1).max(axis=1)
    rplast = jnp.where(seed_end < rlens, seed_end, seed_last_rp)

    # packed mismatch positions for the on-device evidence kernel
    # (pipeline/device_profile.py): up to MM_SLOTS of (read_pos << 2 |
    # read_base), -1 = empty. Reads with more mismatches go slow.
    key = jnp.where(mmask > 0, max_len - jpos[None, :], 0)
    _, mmi = jax.lax.top_k(key, MM_SLOTS)                 # leftmost first
    mrow = jnp.take_along_axis(mmask, mmi, axis=1) > 0
    rbase = jnp.take_along_axis(read_base(read_words, max_len), mmi, axis=1)
    mmp = jnp.where(mrow, (mmi << 2) | rbase, -1).astype(jnp.int32)

    fast = (has_hits & ~too_many & one_diag & has_can & span_ok
            & ~dp_any & ~many_gaps & (mm_total <= MM_SLOTS))
    nocand = (~has_hits) | (has_hits & ~too_many & one_diag & ~has_can)
    cls = jnp.where(fast, CLASS_FAST,
                    jnp.where(nocand, CLASS_NOCAND, CLASS_SLOW))
    return (cls, pd0, mm_total, jnp.clip(rplast, 0, 511),
            jnp.clip(cscore, 0, 511), mmp)


def read_base(read_words: jnp.ndarray, max_len: int) -> jnp.ndarray:
    """Expand bwa-order packed read words to per-position codes [B, max_len]."""
    jpos = np.arange(max_len, dtype=np.int32)
    wsel = jpos >> 4
    sh = jnp.asarray(((15 - (jpos & 15)) * 2).astype(np.uint32))
    return ((read_words[:, wsel] >> sh[None, :]) & 3).astype(jnp.int32)
