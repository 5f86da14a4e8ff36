"""Genome-sharded FM-index over the device mesh — the human-scale
design (SURVEY §2d / §7: "SA-resolution gathers are random-access over
a multi-GB array ... needs genome sharding + request routing, the real
distributed-systems work").

A >1 Gbp fwd+rc text does not fit one chip's HBM at the 18 B/base of
the 3-step occ table. Here the occ3 rows are sharded along the BWT-row
axis over the 'dp' mesh: each device owns a contiguous slice. The
seeding state machine is unchanged (ops/fm_search._seed_scan3) — only
its row gathers are replaced by a ROUTED gather:

  1. all_gather the per-device query indices (each device's read shard
     produces B row indices per step),
  2. every device answers the queries that land in its slice with a
     local gather (others contribute zeros),
  3. psum combines the answers; each device keeps its own lanes.

Per step the collective moves n_dev * B row indices + the combined
rows — bandwidth-wise this rides ICI, which is exactly where the
north-star design wants it. The same routing pattern applies to the
sampled-SA walk (sa_resolve) for full human-scale operation.

Proven bit-exact against the replicated-index kernel on the virtual
CPU mesh (tests/test_mesh.py::test_sharded_index_seeding).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.fm3_device import DeviceFM3
from ..ops.fm_search import MIN_SEED_LEN, _seed_scan3


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class ShardedFM3:
    """DeviceFM3 whose occ3 rows live as per-device slices. Inside
    shard_map, `occ3_local` is this device's slice; row w belongs to
    shard w // rows_per_shard."""
    fm3: DeviceFM3             # occ3_rows replaced by a [0,72] stub
    occ3_local: jnp.ndarray    # int32[rows_per_shard, 72] (per device)
    rows_per_shard: int
    n_shards: int

    def tree_flatten(self):
        return ((self.fm3, self.occ3_local),
                (self.rows_per_shard, self.n_shards))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    # scan pass-throughs (step3/step1 read these off the fm3 object)
    @property
    def L2(self):
        return self.fm3.L2

    @property
    def primary(self):
        return self.fm3.primary

    @property
    def c3_first(self):
        return self.fm3.c3_first

    @property
    def row_p1(self):
        return self.fm3.row_p1

    @property
    def row_p2(self):
        return self.fm3.row_p2

    @property
    def t0(self):
        return self.fm3.t0

    @property
    def t1(self):
        return self.fm3.t1

    @property
    def tail1(self):
        return self.fm3.tail1

    @property
    def tail2a(self):
        return self.fm3.tail2a

    @property
    def tail2b(self):
        return self.fm3.tail2b

    @property
    def pfx_k(self):
        return 0


def shard_occ3_rows(fm3: DeviceFM3, n_shards: int):
    """Pad + split the occ3 rows into n_shards equal slices (host side);
    returns (slices np[n_shards, rps, 72], rows_per_shard)."""
    rows = np.asarray(fm3.occ3_rows)
    nw = rows.shape[0]
    rps = -(-nw // n_shards)
    pad = np.zeros((n_shards * rps, 72), dtype=np.int32)
    pad[:nw] = rows
    return pad.reshape(n_shards, rps, 72), rps


def routed_gather3(sfm: ShardedFM3, i: jnp.ndarray):
    """gather3 over the sharded rows: all_gather the row-word queries,
    answer locally, psum the contributions. Must run inside shard_map
    over the 'dp' axis."""
    w = i >> 4
    all_w = jax.lax.all_gather(w, "dp")                 # [n, B]
    my = jax.lax.axis_index("dp")
    lo = my * sfm.rows_per_shard
    local = all_w - lo
    mine = (local >= 0) & (local < sfm.rows_per_shard)
    rows = sfm.occ3_local[jnp.clip(local, 0, sfm.rows_per_shard - 1)]
    rows = jnp.where(mine[..., None], rows, 0)          # [n, B, 72]
    rows = jax.lax.psum(rows, "dp")
    row = rows[my]                                      # this device's lanes
    cnt64 = row[..., :64]
    sym_bytes = jax.lax.bitcast_convert_type(row[..., 64:68], jnp.uint8)
    syms = sym_bytes.reshape(sym_bytes.shape[:-2] + (16,)).astype(jnp.int32)
    return cnt64, syms, (i & 15)


def build_sharded_seed_scan(fm3: DeviceFM3, mesh: Mesh, n_devices: int,
                            max_len: int, per_device_batch: int):
    """Seeding scan with the occ3 table genome-sharded over the mesh:
    jit fn(occ3_slices [n, rps, 72] sharded over dp, packed codes
    [B_global, max_len/4] sharded, rlens sharded) -> per-read seed
    tables (n_seeds, rpos, len, x0, freq) gathered to the host."""
    B = per_device_batch
    max_seeds = max_len // (MIN_SEED_LEN + 1) + 2
    import dataclasses as dc
    fm3_stub = dc.replace(fm3, occ3_rows=jnp.zeros((0, 72), jnp.int32))

    def device_fn(occ3_local, packed, rlens):
        occ3_local = occ3_local[0]      # shard_map keeps a size-1 lead dim
        rps = occ3_local.shape[0]
        sfm = ShardedFM3(fm3=fm3_stub, occ3_local=occ3_local,
                         rows_per_shard=rps, n_shards=n_devices)
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

        return _seed_scan3(sfm, codes_fn, rlens, B, max_len, max_seeds,
                           gather_fn=routed_gather3, sync_axis="dp")

    fn = jax.jit(
        jax.shard_map(device_fn, mesh=mesh,
                      in_specs=(P("dp", None, None), P("dp", None), P("dp")),
                      out_specs=tuple([P("dp")] + [P("dp", None)] * 4
                                      + [P("dp")])))
    return fn


def _routed_rows(local_rows: jnp.ndarray, rows_per_shard: int,
                 i: jnp.ndarray) -> jnp.ndarray:
    """Generic routed row gather over a table sharded along axis 0:
    all_gather the indices, answer locally, psum. -> rows for this
    device's lanes."""
    all_i = jax.lax.all_gather(i, "dp")
    my = jax.lax.axis_index("dp")
    local = all_i - my * rows_per_shard
    mine = (local >= 0) & (local < rows_per_shard)
    rows = local_rows[jnp.clip(local, 0, rows_per_shard - 1)]
    if rows.ndim > all_i.ndim:
        rows = jnp.where(mine[..., None], rows, 0)
    else:
        rows = jnp.where(mine, rows, 0)
    return jax.lax.psum(rows, "dp")[my]


def build_sharded_sa_resolve(fm, mesh: Mesh, n_devices: int, B: int,
                             max_walk: int = 192):
    """Sampled-SA resolution with BOTH the 1-step occ rows and the
    sampled SA genome-sharded over the mesh: every inverse-Psi step
    routes its row gather through the collectives (the human-scale SA
    walk; ref contract: src/bwt_search.cpp:109-119, bwt.c:101-123).

    jit fn(occ_slices [n, rps, 8], sa_slices [n, sps], k [B_global],
    active [B_global]) -> (loc, resolved), all sharded over dp."""
    primary = fm.primary
    L2 = fm.L2

    def device_fn(occ_local, sa_local, k, active):
        occ_local = occ_local[0]
        sa_local = sa_local[0]
        rps = occ_local.shape[0]
        sps = sa_local.shape[0]

        def routed_inv_psi(kk):
            kadj = kk - (kk >= primary).astype(kk.dtype)
            row = _routed_rows(occ_local, rps, kadj >> 4)
            word = jax.lax.bitcast_convert_type(row[..., 4], jnp.uint32)
            c = ((word >> (((~kadj & 0xF) << 1)).astype(jnp.uint32)) & 3
                 ).astype(jnp.int32)
            base = jnp.take_along_axis(row[..., :4], c[..., None],
                                       axis=-1)[..., 0]
            crumb = (~kadj) & 0xF
            keep = (~((jnp.uint32(1) << (2 * crumb).astype(jnp.uint32))
                      - jnp.uint32(1))) & jnp.uint32(0x55555555)
            xw = word ^ (c.astype(jnp.uint32) * jnp.uint32(0x55555555))
            nx = ~xw
            m = nx & (nx >> 1) & keep
            occ_kc = base + jax.lax.population_count(m).astype(jnp.int32)
            return jnp.where(kk == primary, 0, L2[c] + occ_kc)

        def body(_, state):
            kk, steps = state
            todo = active & ((kk & 31) != 0)
            kn = routed_inv_psi(jnp.where(todo, kk, 32))
            return (jnp.where(todo, kn, kk),
                    jnp.where(todo, steps + 1, steps))

        steps0 = jnp.zeros_like(k)
        kf, stepsf = jax.lax.fori_loop(0, max_walk, body, (k, steps0))
        resolved = active & ((kf & 31) == 0)
        samp = _routed_rows(sa_local, sps, kf >> 5)
        return stepsf + samp, resolved

    fn = jax.jit(
        jax.shard_map(device_fn, mesh=mesh,
                      in_specs=(P("dp", None, None), P("dp", None),
                                P("dp"), P("dp")),
                      out_specs=(P("dp"), P("dp"))))
    return fn


def routed_sa_walk(occ_local, sa_local, primary, L2, k, active,
                   max_walk: int = 192):
    """The sampled-SA inverse-Psi walk with occ rows + SA samples
    sharded (the loop body of build_sharded_sa_resolve, reusable inside
    other shard_mapped kernels). Bit-identical to the replicated walk:
    same algorithm, same rows, fixed lockstep trip count."""
    rps = occ_local.shape[0]
    sps = sa_local.shape[0]

    def routed_inv_psi(kk):
        kadj = kk - (kk >= primary).astype(kk.dtype)
        row = _routed_rows(occ_local, rps, kadj >> 4)
        word = jax.lax.bitcast_convert_type(row[..., 4], jnp.uint32)
        c = ((word >> (((~kadj & 0xF) << 1)).astype(jnp.uint32)) & 3
             ).astype(jnp.int32)
        base = jnp.take_along_axis(row[..., :4], c[..., None],
                                   axis=-1)[..., 0]
        crumb = (~kadj) & 0xF
        keep = (~((jnp.uint32(1) << (2 * crumb).astype(jnp.uint32))
                  - jnp.uint32(1))) & jnp.uint32(0x55555555)
        xw = word ^ (c.astype(jnp.uint32) * jnp.uint32(0x55555555))
        nx = ~xw
        m = nx & (nx >> 1) & keep
        occ_kc = base + jax.lax.population_count(m).astype(jnp.int32)
        return jnp.where(kk == primary, 0, L2[c] + occ_kc)

    def body(_, state):
        kk, steps = state
        todo = active & ((kk & 31) != 0)
        kn = routed_inv_psi(jnp.where(todo, kk, 32))
        return (jnp.where(todo, kn, kk), jnp.where(todo, steps + 1, steps))

    kf, stepsf = jax.lax.fori_loop(0, max_walk, body,
                                   (k, jnp.zeros_like(k)))
    resolved = active & ((kf & 31) == 0)
    return stepsf + _routed_rows(sa_local, sps, kf >> 5), resolved


def build_sharded_chain_kernel(fm3: DeviceFM3, chain_ctx, mesh: Mesh,
                               n_devices: int, max_len: int,
                               batch_global: int, tier: int = 2):
    """The PRODUCTION chain stage (seed -> SA-resolve -> chain/classify,
    ops/fm_search.build_seed_chain_kernel semantics) with the occ3 rows
    genome-sharded over the mesh — the human-scale index path for the
    real backend (pipeline/device_backend.py wires it behind
    cfg.index_shards). The dominant HBM cost (the 96 B/base occ3 table)
    drops to 1/n per chip, and SA resolution routes through sharded
    tables too, matching the single-chip policy branch: full SA in HBM
    -> ONE routed gather of the sharded sa_full (4 B/base -> /n, exact
    parity); sampled-SA walk -> routed_sa_walk over sharded 1-step occ
    rows + SA samples (~2.2 B/base -> /n, same algorithm/rows as the
    replicated walk). Only the text words for the mismatch compare
    (~0.5 B/base) and the tiny correction tables stay replicated.

    jit fn(occ_slices [n, rps, 72], <sa slices — see backend setup>,
    packed [BG, max_len/4] sharded, rlens [BG] sharded) ->
      (cls, pd0, mm, rplast, cscore [BG], mmp [BG, S], overflow [BG],
       hit_read(global), hit_rpos, hit_len, hit_loc, keep [n*Hd],
       buf_ovf [n]) — hits are RAW per-shard segments; the backend
    compacts slow reads' hits host-side (the packed layout is the
    single-chip kernel's transfer optimization)."""
    import dataclasses as dc

    from ..ops.chain_device import CLASS_SLOW, classify_reads

    BG = batch_global
    assert BG % n_devices == 0
    B = BG // n_devices
    max_seeds = max_len // (MIN_SEED_LEN + 1) + 2
    H = B * max(9, tier) // 4
    fm3_stub = dc.replace(fm3, occ3_rows=jnp.zeros((0, 72), jnp.int32))
    fm1 = fm3.fm
    full_sa = bool(fm1.has_full_sa)

    def device_fn(occ3_local, occ1_local, sa_local, packed, rlens):
        occ3_local = occ3_local[0]
        sfm = ShardedFM3(fm3=fm3_stub, occ3_local=occ3_local,
                         rows_per_shard=occ3_local.shape[0],
                         n_shards=n_devices)
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
            sfm, codes_fn, rlens, B, max_len, max_seeds,
            gather_fn=routed_gather3, sync_axis="dp")

        sidx = jnp.arange(max_seeds, dtype=jnp.int32)[None, :]
        seed_valid = sidx < n_seeds[:, None]
        freqs = jnp.where(seed_valid, s_freq, 0).reshape(-1)
        x0s = s_x0.reshape(-1)
        rposs = s_rpos.reshape(-1)
        lens = s_len.reshape(-1)
        readix = jnp.repeat(jnp.arange(B, dtype=jnp.int32), max_seeds)
        total_raw = freqs.sum()
        csum = jnp.cumsum(freqs) - freqs
        hpos = jnp.arange(H, dtype=jnp.int32)
        within = hpos - jnp.repeat(csum, freqs, total_repeat_length=H)
        hit_row = jnp.repeat(x0s, freqs, total_repeat_length=H) + within
        hit_rpos = jnp.repeat(rposs, freqs, total_repeat_length=H)
        hit_len = jnp.repeat(lens, freqs, total_repeat_length=H)
        hit_read = jnp.repeat(readix, freqs, total_repeat_length=H)
        hit_valid = hpos < jnp.minimum(total_raw, H)
        buf_ovf = (total_raw > H).astype(jnp.int32)

        sa_local = sa_local[0]
        k_q = jnp.where(hit_valid, hit_row, 32)
        if full_sa:
            hit_loc = _routed_rows(sa_local, sa_local.shape[0], k_q)
            resolved = hit_valid
        else:
            hit_loc, resolved = routed_sa_walk(
                occ1_local[0], sa_local, fm1.primary, fm1.L2, k_q,
                hit_valid)
        unresolved_read = jnp.zeros(B, dtype=jnp.int32).at[hit_read].max(
            (hit_valid & ~resolved).astype(jnp.int32))
        overflow = overflow | (unresolved_read > 0)
        keep = hit_valid & ((hit_loc - hit_rpos) > 0)

        pb2 = packed.astype(jnp.uint32)
        crumb = jnp.stack([(pb2 >> jnp.uint32(q * 2)) & 3 for q in range(4)],
                          axis=-1).reshape(B, W4 * 4)
        cshift = jnp.asarray(((15 - (np.arange(max_len) & 15)) * 2)
                             .astype(np.uint32))
        cw = (crumb[:, :max_len] << cshift[None, :]).reshape(B, nwords, 16)
        words_bwa = cw.sum(axis=2, dtype=jnp.uint32)
        cls, pd0, mm, rplast, cscore, mmp = classify_reads(
            chain_ctx, words_bwa, rlens, hit_read, hit_rpos, hit_len,
            hit_loc, keep, max_len)
        cls = jnp.where((overflow > 0) if overflow.dtype != jnp.bool_
                        else overflow, CLASS_SLOW, cls)

        keep_slow = keep & (cls[jnp.clip(hit_read, 0, B - 1)] == CLASS_SLOW)
        my = jax.lax.axis_index("dp").astype(jnp.int32)
        hit_read_g = hit_read + my * B
        return (cls, pd0, mm, rplast, cscore, mmp,
                overflow.astype(jnp.int32), hit_read_g, hit_rpos, hit_len,
                hit_loc, keep_slow, buf_ovf[None])

    fn = jax.jit(
        jax.shard_map(device_fn, mesh=mesh,
                      in_specs=(P("dp", None, None), P("dp", None, None),
                                P("dp", None), P("dp", None), P("dp")),
                      out_specs=(P("dp"), P("dp"), P("dp"), P("dp"),
                                 P("dp"), P("dp", None), P("dp"),
                                 P("dp"), P("dp"), P("dp"), P("dp"),
                                 P("dp"), P("dp"))))
    return fn
