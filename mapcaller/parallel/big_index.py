"""x64 big-genome sharded FM-index kernels: device seeding + SA
resolution for texts with >= 2^31 rows (genomes > ~1 Gbp fwd+rc — the
human-scale regime; the reference's index types are uint64 end to end,
ref: src/BWT_Index/bwt.h:44,47-56, and it maps human genomes).

Design (ROADMAP r2 §5, VERDICT r2 next-1): the 288 B occ3 row format
stays int32 by storing counts RELATIVE to the owning genome shard's
base counts (a shard slice spans < 2^31 rows); a tiny replicated
base3[n_shards, 64] int64 table recombines absolute counts on device.
The scan's interval state (x0/x1/x2) runs in int64, which requires
jax_enable_x64 — callers run these kernels inside
`jax.enable_x64(True)` (the standard <2^31 path is untouched
and stays x64-free). Every wraparound-dependent op (crumb masks, symbol
byte unpack) is pinned to explicit int32/uint32.

SA resolution uses the full-SA routed gather (int64 sa_full sharded at
8 B/base / n_shards — at pod scale, human fwd+rc is ~3 GB/chip over 16
chips, well within HBM); the sampled-SA walk stays the <2^31 path's
fallback and is not needed here.

Proven bit-exact vs the host oracle + the int32 sharded kernel on the
virtual CPU mesh (tests/test_big_index.py); the >2^31-row integration
proof is scripts/big_genome_proof.py.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.fm_search import MIN_SEED_LEN, _seed_scan3


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class BigShardedFM3:
    """The fm3 view _seed_scan3 needs, for shard-relative int64 mode.
    Inside shard_map `occ3_local` is this device's slice; global occ3
    word w lives on shard w // rows_per_shard."""
    occ3_local: jnp.ndarray    # int32[rows_per_shard, 72] (per device)
    base3: jnp.ndarray         # int64[n_shards, 64] (replicated)
    c3_first: jnp.ndarray      # int64[64]
    L2: jnp.ndarray            # int64[5]
    rows_per_shard: int
    n_shards: int
    primary: int
    row_p1: int
    row_p2: int
    t0: int
    t1: int
    tail1: int
    tail2a: int
    tail2b: int

    def tree_flatten(self):
        return ((self.occ3_local, self.base3, self.c3_first, self.L2),
                (self.rows_per_shard, self.n_shards, self.primary,
                 self.row_p1, self.row_p2, self.t0, self.t1, self.tail1,
                 self.tail2a, self.tail2b))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @property
    def pfx_k(self):
        return 0


def big_routed_gather3(bfm: BigShardedFM3, i: jnp.ndarray):
    """Routed occ3 gather with shard-relative -> absolute recombination:
    all_gather the int64 row-word queries, answer locally (int32 rows),
    psum, then add the owning shard's int64 base counts. Must run inside
    shard_map over 'dp'."""
    w = i >> 4                                       # int64 occ3 word
    all_w = jax.lax.all_gather(w, "dp")              # [n, B]
    my = jax.lax.axis_index("dp")
    lo = my.astype(w.dtype) * bfm.rows_per_shard
    local = all_w - lo
    mine = (local >= 0) & (local < bfm.rows_per_shard)
    loc32 = jnp.clip(local, 0, bfm.rows_per_shard - 1).astype(jnp.int32)
    rows = bfm.occ3_local[loc32]                     # [n, B, 72] int32
    rows = jnp.where(mine[..., None], rows, 0)
    rows = jax.lax.psum(rows, "dp")
    row = rows[my]                                   # this device's lanes
    shard = jnp.clip(w // bfm.rows_per_shard, 0,
                     bfm.n_shards - 1).astype(jnp.int32)
    cnt64 = row[..., :64].astype(jnp.int64) + bfm.base3[shard]
    sym_bytes = jax.lax.bitcast_convert_type(row[..., 64:68], jnp.uint8)
    syms = sym_bytes.reshape(sym_bytes.shape[:-2] + (16,)).astype(jnp.int32)
    return cnt64, syms, (i & 15).astype(jnp.int32)


def _routed_rows64(local_rows: jnp.ndarray, rows_per_shard: int,
                   i: jnp.ndarray) -> jnp.ndarray:
    """Routed gather over a table sharded along axis 0, int64 indices."""
    all_i = jax.lax.all_gather(i, "dp")
    my = jax.lax.axis_index("dp")
    local = all_i - my.astype(i.dtype) * rows_per_shard
    mine = (local >= 0) & (local < rows_per_shard)
    rows = local_rows[jnp.clip(local, 0, rows_per_shard - 1
                               ).astype(jnp.int32)]
    rows = jnp.where(mine, rows, 0)
    return jax.lax.psum(rows, "dp")[my]


def build_big_seed_hits_kernel(mesh: Mesh, n_devices: int, max_len: int,
                               per_device_batch: int, statics: dict):
    """Seeding scan + full-SA hit resolution with BOTH tables genome-
    sharded and the interval state in int64 — the >2^31-row production
    seeding path. Build (jit) and call inside jax.enable_x64(True).

    statics: dict with primary/row_p1/row_p2/t0/t1/tail1/tail2a/tail2b
    (Python ints; primary may exceed 2^31).

    jit fn(occ3_slices [n, rps, 72], base3 [n_shards, 64] i64,
           c3_first [64] i64, L2 [5] i64, sa_slices [n, sps] i64,
           packed [BG, max_len/4] u8 sharded, rlens [BG] i32 sharded)
      -> (n_seeds, s_rpos, s_len [BG,S] i32, s_x0 [BG,S] i64,
          s_freq [BG,S] i32, overflow [BG] bool,
          hit_read [n*Hd] i32 global, hit_rpos/hit_len [n*Hd] i32,
          hit_loc [n*Hd] i64, hit_valid [n*Hd] bool, buf_ovf [n])"""
    B = per_device_batch
    max_seeds = max_len // (MIN_SEED_LEN + 1) + 2
    H = B * 4

    def device_fn(occ3_local, base3, c3_first, L2, sa_local, packed, rlens):
        occ3_local = occ3_local[0]
        sa_local = sa_local[0]
        bfm = BigShardedFM3(
            occ3_local=occ3_local, base3=base3, c3_first=c3_first, L2=L2,
            rows_per_shard=occ3_local.shape[0], n_shards=n_devices,
            **statics)
        W4 = packed.shape[1]
        nwords = (W4 + 3) // 4
        pb = packed.astype(jnp.uint32).reshape(B, nwords, 4)
        sh = (jnp.arange(4, dtype=jnp.uint32) * 8)[None, None, :]
        words = (pb << sh).sum(axis=2, dtype=jnp.uint32)
        widx = jnp.arange(nwords, dtype=jnp.int32)[None, :]

        def codes_fn(row, pos):
            wi = (pos >> 4)[:, None]
            w = jnp.where(widx == wi, words, 0).sum(axis=1,
                                                    dtype=jnp.uint32)
            return ((w >> ((pos.astype(jnp.uint32) & 15) * 2)) & 3
                    ).astype(jnp.int32)

        (n_seeds, s_rpos, s_len, s_x0, s_freq, overflow) = _seed_scan3(
            bfm, codes_fn, rlens, B, max_len, max_seeds,
            gather_fn=big_routed_gather3, sync_axis="dp",
            idx_dtype=jnp.int64)

        # flat (seed, hit) expansion — mirrors build_sharded_chain_kernel
        sidx = jnp.arange(max_seeds, dtype=jnp.int32)[None, :]
        seed_valid = sidx < n_seeds[:, None]
        freqs = jnp.where(seed_valid, s_freq, 0).astype(jnp.int32
                                                        ).reshape(-1)
        x0s = s_x0.reshape(-1)
        rposs = s_rpos.reshape(-1)
        lens = s_len.reshape(-1)
        readix = jnp.repeat(jnp.arange(B, dtype=jnp.int32), max_seeds)
        total_raw = freqs.sum()
        csum = jnp.cumsum(freqs) - freqs
        hpos = jnp.arange(H, dtype=jnp.int32)
        within = hpos - jnp.repeat(csum, freqs, total_repeat_length=H)
        hit_row = (jnp.repeat(x0s, freqs, total_repeat_length=H)
                   + within.astype(jnp.int64))
        hit_rpos = jnp.repeat(rposs, freqs, total_repeat_length=H)
        hit_len = jnp.repeat(lens, freqs, total_repeat_length=H)
        hit_read = jnp.repeat(readix, freqs, total_repeat_length=H)
        hit_valid = hpos < jnp.minimum(total_raw, H)
        buf_ovf = (total_raw > H).astype(jnp.int32)

        k_q = jnp.where(hit_valid, hit_row, 0)
        hit_loc = _routed_rows64(sa_local, sa_local.shape[0], k_q)
        my = jax.lax.axis_index("dp").astype(jnp.int32)
        s_freq32 = jnp.where(seed_valid, s_freq, 0).astype(jnp.int32)
        return (n_seeds, s_rpos, s_len, s_x0, s_freq32, overflow,
                hit_read + my * B, hit_rpos, hit_len, hit_loc, hit_valid,
                buf_ovf[None])

    fn = jax.jit(
        jax.shard_map(device_fn, mesh=mesh,
                      in_specs=(P("dp", None, None), P(None, None), P(None),
                                P(None), P("dp", None), P("dp", None),
                                P("dp")),
                      out_specs=tuple([P("dp")] + [P("dp", None)] * 4
                                      + [P("dp")] * 7)))
    return fn


def build_big_chain_kernel(mesh: Mesh, n_devices: int, max_len: int,
                           batch_global: int, statics: dict, seq_len: int,
                           tier: int = 2):
    """The x64 PRODUCTION chain stage (seed -> routed SA -> device
    chain/classify) for >2^31-row texts: build_sharded_chain_kernel's
    contract with the interval state, hit locations, and diagonals in
    int64 (the reference's coordinates are bwtint_t = uint64 end to
    end — ref: src/BWT_Index/bwt.h:44; classification logic matches
    ReadAlignment.cpp:184-232 via ops/chain_device.classify_reads).
    Build (jit) and call inside jax.enable_x64(True).

    seq_len: text length 2L (python int; may exceed 2^31).
    jit fn(occ3 [n, rps, 72] i32, base3 [ns, 64] i64, c3_first [64] i64,
           L2 [5] i64, sa [n, sps] i64, text_words [nw+1] u32 replicated,
           bkeys [nb] i64 replicated, packed [BG, max_len/4] u8 sharded,
           rlens [BG] i32 sharded) ->
      (cls, mm, rplast, cscore i32[BG], pd0 i64[BG], mmp i32[BG, 4],
       overflow i32[BG], hit_read(global) i32, hit_rpos, hit_len i32,
       hit_loc i64, keep_slow bool [n*H], buf_ovf i32[n])"""
    from ..ops.chain_device import CLASS_SLOW, ChainCtx, classify_reads

    BG = batch_global
    assert BG % n_devices == 0
    B = BG // n_devices
    max_seeds = max_len // (MIN_SEED_LEN + 1) + 2
    H = B * max(9, tier) // 4

    def device_fn(occ3_local, base3, c3_first, L2, sa_local, text_words,
                  bkeys, packed, rlens):
        occ3_local = occ3_local[0]
        sa_local = sa_local[0]
        bfm = BigShardedFM3(
            occ3_local=occ3_local, base3=base3, c3_first=c3_first, L2=L2,
            rows_per_shard=occ3_local.shape[0], n_shards=n_devices,
            **statics)
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

        (n_seeds, s_rpos, s_len, s_x0, s_freq, overflow) = _seed_scan3(
            bfm, codes_fn, rlens, B, max_len, max_seeds,
            gather_fn=big_routed_gather3, sync_axis="dp",
            idx_dtype=jnp.int64)

        sidx = jnp.arange(max_seeds, dtype=jnp.int32)[None, :]
        seed_valid = sidx < n_seeds[:, None]
        freqs = jnp.where(seed_valid, s_freq, 0).astype(jnp.int32
                                                        ).reshape(-1)
        x0s = s_x0.reshape(-1)
        rposs = s_rpos.reshape(-1)
        lens = s_len.reshape(-1)
        readix = jnp.repeat(jnp.arange(B, dtype=jnp.int32), max_seeds)
        total_raw = freqs.sum()
        csum = jnp.cumsum(freqs) - freqs
        hpos = jnp.arange(H, dtype=jnp.int32)
        within = hpos - jnp.repeat(csum, freqs, total_repeat_length=H)
        hit_row = (jnp.repeat(x0s, freqs, total_repeat_length=H)
                   + within.astype(jnp.int64))
        hit_rpos = jnp.repeat(rposs, freqs, total_repeat_length=H)
        hit_len = jnp.repeat(lens, freqs, total_repeat_length=H)
        hit_read = jnp.repeat(readix, freqs, total_repeat_length=H)
        hit_valid = hpos < jnp.minimum(total_raw, H)
        buf_ovf = (total_raw > H).astype(jnp.int32)

        k_q = jnp.where(hit_valid, hit_row, 32)
        hit_loc = _routed_rows64(sa_local, sa_local.shape[0], k_q)
        keep = hit_valid & ((hit_loc - hit_rpos) > 0)

        # bwa-order read words for the text mismatch compare
        pb2 = packed.astype(jnp.uint32)
        crumb = jnp.stack([(pb2 >> jnp.uint32(q * 2)) & 3
                           for q in range(4)], axis=-1).reshape(B, W4 * 4)
        cshift = jnp.asarray(((15 - (np.arange(max_len) & 15)) * 2)
                             .astype(np.uint32))
        cw = (crumb[:, :max_len] << cshift[None, :]).reshape(B, nwords, 16)
        words_bwa = cw.sum(axis=2, dtype=jnp.uint32)
        ctx = ChainCtx(text_words=text_words, bkeys=bkeys, seq_len=seq_len)
        cls, pd0, mm, rplast, cscore, mmp = classify_reads(
            ctx, words_bwa, rlens, hit_read, hit_rpos, hit_len,
            hit_loc, keep, max_len)
        cls = jnp.where(overflow, CLASS_SLOW, cls)

        keep_slow = keep & (cls[jnp.clip(hit_read, 0, B - 1)] == CLASS_SLOW)
        my = jax.lax.axis_index("dp").astype(jnp.int32)
        return (cls, pd0, mm, rplast, cscore, mmp,
                overflow.astype(jnp.int32), hit_read + my * B, hit_rpos,
                hit_len, hit_loc, keep_slow, buf_ovf[None])

    fn = jax.jit(
        jax.shard_map(device_fn, mesh=mesh,
                      in_specs=(P("dp", None, None), P(None, None), P(None),
                                P(None), P("dp", None), P(None), P(None),
                                P("dp", None), P("dp")),
                      out_specs=(P("dp"), P("dp"), P("dp"), P("dp"),
                                 P("dp"), P("dp", None), P("dp"),
                                 P("dp"), P("dp"), P("dp"), P("dp"),
                                 P("dp"), P("dp"))))
    return fn


def shard_rows(arr: np.ndarray, n_shards: int, pad_value=0):
    """Pad + split a table into n_shards equal axis-0 slices ->
    (np[n_shards, rps, ...], rps)."""
    m = arr.shape[0]
    rps = -(-m // n_shards)
    out = np.full((n_shards * rps,) + arr.shape[1:], pad_value,
                  dtype=arr.dtype)
    out[:m] = arr
    return out.reshape((n_shards, rps) + arr.shape[1:]), rps
