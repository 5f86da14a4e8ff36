"""Device-resident 3-step FM-index lookups (see index/occ3.py for the
table layout and conventions).

Everything the greedy-MEM state machine needs per iteration derives
from TWO gathered 288-byte occ3 rows (interval start and end):

  * the 3-step interval update for the prepended trinucleotide,
  * the 1-step update (tail bases / exact-MEM-end replay) via group
    sums over the 64 counts plus the row_p1/row_p2 corrections,
  * the forward-interval (x0) ordering sums via the arithmetic
    bit-reversal rev3(d) = 63 - ((d&3)*16 + (d&12) + (d>>4)).

Replaces the per-base occ4 pair of ops/fm_device.py in the seeding hot
loop (ref: src/bwt_search.cpp:121-164): ~3x fewer sequential gathers.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..index.fmindex import FMIndex
from ..index.occ3 import build_occ3
from .fm_device import DeviceFMIndex


@functools.partial(jax.jit, static_argnums=(2, 3))
def _occ3_rows_device(sa: jnp.ndarray, words: jnp.ndarray,
                      n: int, nw3: int):
    """Build the occ3 table ON DEVICE from the (already-resident) full
    SA and packed text words, instead of shipping an 18 B/text-base
    precomputed table from the host: uploads drop from ~36 B/genome-base
    to the ~4.5 B/base the SA+text already cost, and the derivation is
    a few elementwise/gather passes (~seconds) — the device-side
    equivalent of the reference interleaving Occ checkpoints into its
    stored .bwt (ref: src/BWT_Index/bwtindex.c:53-75). Bit-identical to
    index/occ3.build_occ3 (tests/test_fm3_device_build.py).

    -> (rows int32[nw3, 72], c3_first int32[64],
        pp int32[2] = (row_p1, row_p2))."""
    total = nw3 * 16
    p = jnp.concatenate([sa.astype(jnp.int32),
                         jnp.full(total - sa.shape[0], -1, jnp.int32)])
    # sym[j] = T[p-3]*16 + T[p-2]*4 + T[p-1]; the three crumbs live in
    # at most two adjacent bwa-order words (T[i] = w[i>>4] >> (15-i&15)*2)
    q = jnp.clip(p - 3, 0, n)
    wi = q >> 4
    off = q & 15
    w0 = words[wi].astype(jnp.uint32)
    w1 = words[wi + 1].astype(jnp.uint32)
    sh_a = (jnp.maximum(13 - off, 0) * 2).astype(jnp.uint32)
    sym_a = (w0 >> sh_a) & 63
    sym_b = ((w0 & 15) << 2) | (w1 >> 30)
    sym_c = ((w0 & 3) << 4) | (w1 >> 28)
    sym3 = jnp.where(off <= 13, sym_a,
                     jnp.where(off == 14, sym_b, sym_c)).astype(jnp.int32)
    sym = jnp.where(p >= 3, sym3, 255)
    blocks = sym.reshape(nw3, 16)

    d_row = jnp.arange(64, dtype=jnp.int32)[None, :]
    per = jnp.zeros((nw3, 64), jnp.int32)
    for k in range(16):
        per = per + (blocks[:, k:k + 1] == d_row).astype(jnp.int32)
    cnt = jnp.concatenate([jnp.zeros((1, 64), jnp.int32),
                           jnp.cumsum(per, axis=0)[:-1]])

    # pack 4 symbol bytes/word via 1-D strided slices: a [nw3, 4, 4]
    # reshape here cost 32x tile padding (14.3 GB at 60 Mb genomes —
    # XLA pads minor dims to the (8,128) tile)
    su = sym.astype(jnp.uint32)
    packed_flat = (su[0::4] + (su[1::4] << 8) + (su[2::4] << 16)
                   + (su[3::4] << 24))
    packed_i32 = jax.lax.bitcast_convert_type(
        packed_flat, jnp.int32).reshape(nw3, 4)
    rows = jnp.concatenate(
        [cnt, packed_i32, jnp.zeros((nw3, 4), jnp.int32)], axis=1)

    # c3_first[d] = #{suffixes whose base-5 start key < dkey(d)} — a
    # multiset count, so no sort is needed (the host path's
    # searchsorted over SA-ordered keys computes the same quantity)
    i = jnp.arange(n, dtype=jnp.int32)
    T = ((words[i >> 4].astype(jnp.uint32)
          >> (((15 - (i & 15)) * 2).astype(jnp.uint32))) & 3).astype(jnp.int32)
    k0 = jnp.concatenate([T + 1, jnp.zeros(1, jnp.int32)])
    k1 = jnp.concatenate([T[1:] + 1, jnp.zeros(2, jnp.int32)])
    k2 = jnp.concatenate([T[2:] + 1, jnp.zeros(3, jnp.int32)])
    keys = k0 * 25 + k1 * 5 + k2
    d = np.arange(64)
    dkeys = ((d >> 4) + 1) * 25 + (((d >> 2) & 3) + 1) * 5 + ((d & 3) + 1)
    c3_first = jnp.stack(
        [(keys < int(dk)).sum(dtype=jnp.int32) for dk in dkeys])

    pp = jnp.stack([jnp.argmax(sa == 1).astype(jnp.int32),
                    jnp.argmax(sa == 2).astype(jnp.int32)])
    return rows, c3_first, pp


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class DeviceFM3:
    """pfx_base > 0 enables the FUSED prefix-skip: the interval states
    after the first pfx_k bases of every possible extension start are
    EMBEDDED as extra 288-byte rows at occ3_rows[pfx_base + key], so an
    extension start hijacks its iteration's first occ3 gather slot (the
    start lane was gathering a dummy row anyway) and jumps pfx_k bases
    at ZERO extra gathers per iteration — the in-loop skip VERDICT r2
    rejected cost one extra gather for every lane every step."""
    fm: DeviceFMIndex          # 1-step table (sa_resolve / inv_psi) + L2
    occ3_rows: jnp.ndarray     # int32[nw3 (+ 4^pfx_k), 72]
    c3_first: jnp.ndarray      # int32[64]
    row_p1: int                # static correction constants
    row_p2: int
    t0: int
    t1: int
    tail1: int
    tail2a: int
    tail2b: int
    pfx_k: int = 0
    pfx_base: int = 0          # first prefix row index (0 = disabled)

    def tree_flatten(self):
        return ((self.fm, self.occ3_rows, self.c3_first),
                (self.row_p1, self.row_p2, self.t0, self.t1,
                 self.tail1, self.tail2a, self.tail2b, self.pfx_k,
                 self.pfx_base))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], children[2],
                   *aux[:7], pfx_k=aux[7], pfx_base=aux[8])

    # convenience pass-throughs for the shared scan/compaction code
    @property
    def L2(self):
        return self.fm.L2

    @property
    def primary(self):
        return self.fm.primary

    @property
    def seq_len(self):
        return self.fm.seq_len

    @classmethod
    def from_host(cls, idx: FMIndex,
                  dev_fm: DeviceFMIndex | None = None,
                  pfx_k: int = 0,
                  text_words: jnp.ndarray | None = None) -> "DeviceFM3":
        if idx.sa_full is None:
            raise NotImplementedError("occ3 build requires sa_full (use the "
                                      "1-step kernel for >1Gbp genomes)")
        assert 0 <= pfx_k <= 15   # must stay below MinSeedLength
        fm = dev_fm if dev_fm is not None else DeviceFMIndex.from_host(idx)
        if fm.has_full_sa and idx.sa_full.dtype == np.int32:
            # derive the table on device from the resident SA + packed
            # text (see _occ3_rows_device): no 18 B/base host table to
            # build, persist, or upload
            if text_words is None:
                from ..index.fmindex import pack_words
                w = pack_words(idx.ref.fwd_rc_codes())
                text_words = jnp.asarray(
                    np.concatenate([w, np.zeros(2, dtype=np.uint32)]))
            n = idx.seq_len
            nw3 = (n + 16) // 16 + 2
            rows, c3_first, pp = _occ3_rows_device(fm.sa_full, text_words,
                                                   n, nw3)
            pp = np.asarray(pp)
            c0, c1 = int(idx.ref.codes[0]), int(idx.ref.codes[1])
            kw = dict(fm=fm, occ3_rows=rows, c3_first=c3_first,
                      row_p1=int(pp[0]), row_p2=int(pp[1]),
                      t0=c0, t1=c1, tail1=3 - c0,
                      tail2a=3 - c1, tail2b=3 - c0)
        else:
            # no device-resident SA: fall back to the persisted artifact
            # (disk memmap) or a host rebuild (~2.8 s/Mb)
            tab = idx.occ3_table
            if tab is None:
                tab = build_occ3(idx.sa_full, idx.ref.fwd_rc_codes())
            kw = dict(fm=fm,
                      occ3_rows=jnp.asarray(tab.rows),
                      c3_first=jnp.asarray(tab.c3_first),
                      row_p1=tab.row_p1, row_p2=tab.row_p2,
                      t0=tab.t0, t1=tab.t1, tail1=tab.tail1,
                      tail2a=tab.tail2a, tail2b=tab.tail2b)
        pfx_base = 0
        nrows = int(kw["occ3_rows"].shape[0])
        # fused skip rows must keep (row << 4) + entry inside int32
        # (16 prefix entries pack into each appended 72-int32 row)
        if pfx_k > 1 and ((nrows + (1 << (2 * pfx_k)) // 16 + 2) << 4
                          ) < (1 << 31):
            tab_p = build_prefix_table(fm, pfx_k)          # [4^K, 4]
            kw["occ3_rows"] = _embed_pfx(kw["occ3_rows"], tab_p)
            pfx_base = nrows
        else:
            pfx_k = 0
        return cls(pfx_k=pfx_k, pfx_base=pfx_base, **kw)


@jax.jit
def _embed_pfx(rows: jnp.ndarray, pfx_tab: jnp.ndarray) -> jnp.ndarray:
    """Append the prefix-skip states PACKED 16 entries per 72-int32 row
    (entry e of row r = counts slots [4e, 4e+4) = (x0, x1, x2, 0)) so
    they share the occ3 gather path at 18 B/entry instead of one
    288-byte row per entry: K = 13 costs 1.2 GB of HBM instead of
    19.3 GB, which is what makes skips deeper than 11 fit at all. The
    gather index for prefix key p is (pfx_base << 4) + p — the row part
    p >> 4 and the within-row entry p & 15 fall out of the same
    (row << 4) | m encoding the occ3 path already uses."""
    n_ent = pfx_tab.shape[0]          # 4^K, K >= 2 so a multiple of 16
    packed = pfx_tab.reshape(n_ent // 16, 64)
    ext = jnp.concatenate(
        [packed,
         jnp.zeros((n_ent // 16, rows.shape[1] - 64), jnp.int32)], axis=1)
    return jnp.concatenate([rows, ext], axis=0)


def gather3(fm3: DeviceFM3, i: jnp.ndarray):
    """One row gather: (cnt64 int32[...,64], syms int32[...,16], m=i&15).
    Symbol bytes unpack via one bitcast (no per-byte shifts)."""
    row = fm3.occ3_rows[i >> 4]
    cnt64 = row[..., :64]
    sym_bytes = jax.lax.bitcast_convert_type(row[..., 64:68], jnp.uint8)
    syms = sym_bytes.reshape(sym_bytes.shape[:-2] + (16,)).astype(jnp.int32)
    return cnt64, syms, (i & 15)


_QPOS = np.arange(16, dtype=np.int32)
_D64 = np.arange(64, dtype=np.int32)


def occ3_d(cnt64, syms, m, onehot_d, d):
    """Occ3(d, i): # rows j < i with symbol d. onehot_d bool[...,64] is
    shared across call sites (avoids per-lane gathers)."""
    base = jnp.where(onehot_d, cnt64, 0).sum(axis=-1)
    part = ((syms == d[..., None]) &
            (_QPOS[None, :] < m[..., None])).sum(axis=-1)
    return base + part


def occ1_4(fm3: DeviceFM3, cnt64, syms, m, i):
    """Derived 1-step counts for all 4 bases at row index i
    (== bwa bwt_occ4(i-1), ref: src/bwt_search.cpp:49-66): group sums of
    the 64 trinucleotide counts by last base + the two excluded-row
    corrections (rows p=1, p=2 have 1-char contexts T[0], T[1])."""
    B = cnt64.shape[:-1]
    grp = cnt64.reshape(B + (16, 4)).sum(axis=-2)            # [...,4]
    valid = (syms < 64) & (_QPOS[None, :] < m[..., None])
    lane_c = syms & 3
    part = jnp.stack([(valid & (lane_c == c)).sum(axis=-1) for c in range(4)],
                     axis=-1)
    out = grp + part
    # rows p=1/p=2 precede row index i => their 1-char contexts count
    corr1 = (i > fm3.row_p1).astype(jnp.int32)
    corr2 = (i > fm3.row_p2).astype(jnp.int32)
    oh1 = jnp.zeros(4, jnp.int32).at[fm3.t0].set(1)   # t0/t1 are static
    oh2 = jnp.zeros(4, jnp.int32).at[fm3.t1].set(1)
    return out + corr1[..., None] * oh1 + corr2[..., None] * oh2


_REV3 = 63 - ((_D64 & 3) * 16 + (_D64 & 12) + (_D64 >> 4))


def rev3_lt_w_sum(cnt64, syms, m, w):
    """For the x0 ordering update: checkpoint part
    sum_d cnt64[d]*[rev3(d) < w] and within-word part
    #\\{q < m : sym_q valid, rev3(sym_q) < w\\}. Returns their sum."""
    mask = _REV3[None, :] < w[..., None]
    base = jnp.where(mask, cnt64, 0).sum(axis=-1)
    rev_s = 63 - ((syms & 3) * 16 + (syms & 12) + (syms >> 4))
    part = ((syms < 64) & (rev_s < w[..., None]) &
            (_QPOS[None, :] < m[..., None])).sum(axis=-1)
    return base + part


def step3_update(fm3: DeviceFM3, x0, x1, x2, e0, e1, e2, gk, gl):
    """3-step interval update for appending read bases e0,e1,e2 (forward
    order). gk/gl = gather3 results at x1 and x1+x2.
    Returns (new_x0, new_x1, new_x2)."""
    cntK, symsK, mK = gk
    cntL, symsL, mL = gl
    d = (3 - e2) * 16 + (3 - e1) * 4 + (3 - e0)
    w = e0 * 16 + e1 * 4 + e2
    onehot_d = _D64[None, :] == d[..., None]
    tk3 = occ3_d(cntK, symsK, mK, onehot_d, d)
    tl3 = occ3_d(cntL, symsL, mL, onehot_d, d)
    new_x1 = jnp.where(onehot_d, fm3.c3_first[None, :], 0).sum(axis=-1) + tk3
    new_x2 = tl3 - tk3
    lo, hi = x1, x1 + x2   # interval [lo, hi)
    x0_extra = rev3_lt_w_sum(cntL, symsL, mL, w) - rev3_lt_w_sum(cntK, symsK, mK, w)

    def contains(r):
        return ((lo <= r) & (r < hi)).astype(jnp.int32)

    cmp1 = (fm3.tail1 <= e0).astype(jnp.int32)
    cmp2 = ((fm3.tail2a < e0) |
            ((fm3.tail2a == e0) & (fm3.tail2b <= e1))).astype(jnp.int32)
    adj = (contains(fm3.primary) + contains(fm3.row_p1) * cmp1
           + contains(fm3.row_p2) * cmp2)
    new_x0 = x0 + adj + x0_extra
    return new_x0, new_x1, new_x2


def step1_update(fm3: DeviceFM3, x0, x1, x2, e0, gk, gl):
    """Derived 1-step update for appending read base e0 — identical
    semantics to the occ4 ladder in fm_search._seed_scan
    (ref: src/bwt_search.cpp:121-164 / bwa bwt_extend)."""
    L2 = fm3.L2
    cntK, symsK, mK = gk
    cntL, symsL, mL = gl
    tk = occ1_4(fm3, cntK, symsK, mK, x1)
    tl = occ1_4(fm3, cntL, symsL, mL, x1 + x2)
    ok_x1 = L2[:4][None, :] + 1 + tk
    ok_x2 = tl - tk
    adj = ((x1 <= fm3.primary) & (x1 + x2 - 1 >= fm3.primary)).astype(x0.dtype)
    ok3_x0 = x0 + adj
    ok2_x0 = ok3_x0 + ok_x2[:, 3]
    ok1_x0 = ok2_x0 + ok_x2[:, 2]
    ok0_x0 = ok1_x0 + ok_x2[:, 1]
    ok_x0 = jnp.stack([ok0_x0, ok1_x0, ok2_x0, ok3_x0], axis=-1)
    ci = 3 - e0
    onehot_c = (jnp.arange(4, dtype=jnp.int32)[None, :] == ci[:, None])
    new_x0 = jnp.where(onehot_c, ok_x0, 0).sum(axis=-1)
    new_x1 = jnp.where(onehot_c, ok_x1, 0).sum(axis=-1)
    new_x2 = jnp.where(onehot_c, ok_x2, 0).sum(axis=-1)
    return new_x0, new_x1, new_x2


def build_prefix_table(fm: "DeviceFMIndex", K: int) -> jnp.ndarray:
    """Interval-state lookup table for all 4^K read prefixes: entry
    (e0..e_{K-1}) holds (x0, x1, x2, 0) after K forward-extension steps
    from scratch, built level-by-level on device with the occ4 ladder
    (~2*4^K gathers total). An extension start then jumps K bases with
    ONE 16-byte gather instead of K sequential occ steps; an empty
    entry (x2 == 0, MEM ends inside the first K bases) falls back to
    the 1-step walk, which finds the exact end (K < MinSeedLength, so
    such seeds are discarded either way — only the skip distance needs
    to be exact)."""
    from .fm_device import occ4

    @jax.jit
    def build(fm):
        L2 = fm.L2
        c = jnp.arange(4, dtype=jnp.int32)
        x0 = (L2[c] + 1).astype(jnp.int32)
        x1 = (L2[3 - c] + 1).astype(jnp.int32)
        x2 = (L2[c + 1] - L2[c]).astype(jnp.int32)
        for _ in range(1, K):
            alive = x2 > 0
            k1 = jnp.where(alive, x1 - 1, 0)
            k2 = jnp.where(alive, x1 - 1 + x2, 0)
            tk = occ4(fm, k1)
            tl = occ4(fm, k2)
            ok_x1 = L2[:4][None, :] + 1 + tk
            ok_x2 = tl - tk
            adj = ((x1 <= fm.primary) & (x1 + x2 - 1 >= fm.primary)
                   ).astype(jnp.int32)
            ok3 = x0 + adj
            ok2 = ok3 + ok_x2[:, 3]
            ok1 = ok2 + ok_x2[:, 2]
            ok0 = ok1 + ok_x2[:, 1]
            ok_x0 = jnp.stack([ok0, ok1, ok2, ok3], axis=1)
            ci = 3 - jnp.arange(4)
            x0 = ok_x0[:, ci].reshape(-1).astype(jnp.int32)
            x1 = ok_x1[:, ci].reshape(-1).astype(jnp.int32)
            x2 = jnp.where(jnp.repeat(alive, 4),
                           ok_x2[:, ci].reshape(-1), 0).astype(jnp.int32)
        zero = jnp.zeros_like(x0)
        return jnp.stack([x0, x1, x2, zero], axis=1)

    return build(fm)
