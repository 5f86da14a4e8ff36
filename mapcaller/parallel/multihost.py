"""Multi-host execution harness: jax.distributed + per-host input
shards + ONE cross-host allreduce of the evidence planes.

Each host maps its shard of the read stream through the PRODUCTION
pipeline — native C++ parsing/pairing/slow path + device seed/chain
kernels + HBM evidence planes (pipeline/stream.py, exactly what the
single-host CLI runs) — evidence stays RAW (unfolded diff endpoints),
and a single psum over the global mesh (NVLink within a host, the
network across hosts) reduces the planes before host 0 folds once (cap-after-sum)
and runs the caller. The multi-process CPU backend (one process per
"host", one virtual device each) rehearses the exact collective code
path without multi-host hardware — the 2-process tests assert the merged
VCF is byte-identical to a single-process run for both single-end and
paired-end input.

Caveats mirrored from parallel/distributed.py: the PCR-duplicate gate
is per-host (shard duplicates together to preserve it); paired-end
fragment-size estimation is per-host (the reference has no multi-host
mode to define a contract against).

Event maps (indel seqs of any length, breakpoints) and discord sites
ride a second collective: a var-length int32 record stream (counts
carried once per unique event), sized by a pmax agreement across
processes, all_gathered and decoded on host 0 (JAX default arrays are
int32; int64 in collectives silently truncates with x64 off).
"""
from __future__ import annotations

import argparse
import functools
import os
import numpy as np

AUX_WORD_CAP = 64 << 20   # 256 MB of int32 words — truncate (warn) past this


def _serialize_aux(profile, inv_sites, tnl_sites) -> np.ndarray:
    """Events + discord sites -> var-length int32 word stream (counts
    carried once per unique event, indel seqs of ANY length packed
    2-bit — no fixed EVENT_CAP / 8 bp limits). Records:
      [0, g, kind, count, len, seq_word...]   event (kind: 0 bp 1 ins 2 del)
      [1, g, d, k]                            discord site (k: 0 inv 1 tnl)
    (int32 words: JAX default arrays are int32; int64 in collectives
    silently truncates with x64 off.)"""
    out = []

    def pack(g, kind, seq, count):
        words = []
        for w0 in range(0, len(seq), 15):   # 15 bases = 30 bits (int32-safe)
            s2 = 0
            for i, ch in enumerate(seq[w0:w0 + 15]):
                s2 |= "ACGT".index(ch) << (2 * i)
            words.append(s2)
        out.extend([0, g, kind, count, len(seq)] + words)

    for g, cnt in profile.break_point.items():
        pack(g, 0, "", cnt)
    for kind, table in ((1, profile.insert_map), (2, profile.delete_map)):
        for g, inner in table.items():
            for seq, cnt in inner.items():
                pack(g, kind, seq, cnt)
    for g, d in inv_sites:
        out.extend([1, g, d, 0])
    for g, d in tnl_sites:
        out.extend([1, g, d, 1])
    arr = np.asarray(out, dtype=np.int32)
    if arr.size > AUX_WORD_CAP:
        # degrade gracefully: drop whole records past the cap
        import sys
        end = 0
        while end < AUX_WORD_CAP:
            step = (5 + (arr[end + 4] + 14) // 15) if arr[end] == 0 else 4
            if end + step > AUX_WORD_CAP:
                break
            end += step
        print(f"[multihost] WARNING: aux stream {arr.size} words exceeds "
              f"cap {AUX_WORD_CAP}; truncating", file=sys.stderr)
        arr = arr[:end]
    return arr


def _decode_aux(arr: np.ndarray, used: int, profile, inv_sites,
                tnl_sites) -> None:
    i = 0
    a = arr[:used].tolist()
    while i < used:
        tag = a[i]
        if tag == 0:
            g, kind, count, ln = a[i + 1:i + 5]
            nw = (ln + 14) // 15
            seq = "".join("ACGT"[(a[i + 5 + j // 15] >> (2 * (j % 15))) & 3]
                          for j in range(ln))
            i += 5 + nw
            if kind == 0:
                profile.break_point[g] = profile.break_point.get(g, 0) + count
            else:
                tbl = profile.insert_map if kind == 1 else profile.delete_map
                inner = tbl.setdefault(g, {})
                inner[seq] = inner.get(seq, 0) + count
        else:
            g, d, k = a[i + 1:i + 4]
            (inv_sites if k == 0 else tnl_sites).append((g, d))
            i += 4


def _shard_fastq(src: str, dst: str, process_id: int, num_processes: int,
                 interleaved: bool = False) -> int:
    """Write this host's read shard: record i goes to host
    (i // (2 if interleaved else 1)) % num_processes, so mates co-locate
    on one host (the pairing/rescue state is per-host, mirroring the
    reference's per-thread chunks, ReadMapping.cpp:735-736). FASTA
    records may wrap sequence over multiple lines (the 70-column format
    this repo itself writes); FASTQ is fixed 4-line. Returns the number
    of records written."""
    import gzip
    op = gzip.open if src.endswith(".gz") else open
    n_written = 0
    with op(src, "rt") as f, open(dst, "w") as out:
        first = f.read(1)
        f.seek(0)
        fastq = first == "@"
        idx_rec = 0

        def emit(rec):
            nonlocal n_written, idx_rec
            pair_ix = idx_rec // 2 if interleaved else idx_rec
            if pair_ix % num_processes == process_id:
                out.writelines(rec)
                n_written += 1
            idx_rec += 1

        if fastq:
            rec = []
            for line in f:
                rec.append(line)
                if len(rec) == 4:
                    emit(rec)
                    rec = []
        else:
            rec = []
            for line in f:
                if line.startswith(">") and rec:
                    emit(rec)
                    rec = []
                rec.append(line)
            if rec:
                emit(rec)
    return n_written


def run_host(process_id: int, num_processes: int, coordinator: str,
             fasta: str, reads: str, out_vcf: str, cmd_line: str,
             reads2: str | None = None, devices: int = 1) -> None:
    """One host process running the PRODUCTION pipeline on its read
    shard — native C++ parsing/pairing/slow path + device seed/chain
    kernels + HBM evidence planes (pipeline/stream.py, the same path the
    single-host CLI runs) — then ONE global psum of the RAW diff planes
    (saturation applied once after the reduction, cap-after-sum) and,
    on host 0, a single finalize + caller pass. Reference merge analog:
    ReadMapping.cpp:627-643 under the real engine.

    devices > 1 composes the per-host data-parallel axis (-devices N,
    parallel/devices.py — N local chips round-robin over this host's
    stream batches, ordered host leg, per-chip planes merged locally
    before the raw download) with the cross-host psum: N chips/host x
    M processes, the reference's threads-compose-trivially analog
    (ReadMapping.cpp:735-736)."""
    import tempfile
    import time as _time

    import jax

    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ..calling.caller import cal_block_read_depth, identify_variants
    from ..cli import VERSION_STR
    from ..config import Config
    from ..index.fmindex import build_index
    from ..io.vcf import write_meta, write_variants
    from ..pipeline.device_backend import DeviceBackend
    from ..pipeline.engine import MappingEngine
    from ..pipeline.stream import run_stream_mapping

    cfg = Config(vcf_file=out_vcf, log_file=out_vcf + ".log",
                 batch_size=256, stream_batch_size=512, max_read_len=128,
                 devices=devices)
    idx = build_index(fasta)
    if devices > 1:
        from .devices import MultiDeviceBackend
        backend = MultiDeviceBackend(idx, cfg, devices)
    else:
        backend = DeviceBackend(idx, cfg)
    engine = MappingEngine(idx, cfg, backend=backend)
    assert engine.native is not None, "production path requires the C++ runtime"

    # per-host input shard, mates co-located
    tmpd = tempfile.mkdtemp(prefix=f"mh{process_id}_")
    f1 = os.path.join(tmpd, "r1.fq")
    _shard_fastq(reads, f1, process_id, num_processes,
                 interleaved=cfg.pair_interleaved)
    cfg.read_files1 = [f1]
    if reads2 is not None:
        f2 = os.path.join(tmpd, "r2.fq")
        _shard_fastq(reads2, f2, process_id, num_processes)
        cfg.read_files2 = [f2]
    run_stream_mapping(engine, cfg, _time.time())

    p = engine.profile
    L = idx.genome_size
    if engine.device_evidence is not None:
        # pull the RAW (unfolded, uncapped) device planes into the host
        # diff arrays so saturation happens exactly once, globally
        engine.device_evidence.download_raw_into(p)
        engine.device_evidence = None
    if p.F1_diff is None:
        p.alloc_diffs()

    # ---- ONE allreduce of the raw evidence planes over the mesh -------
    # (scalar stats ride the aux all_gather instead: read_length_sum is
    # total mapped bases and exceeds int32 at ~2.1 Gbp/host, so they are
    # hi/lo int32 pairs summed in Python on host 0)
    st = engine.stats
    local = np.concatenate([
        p.acgt.reshape(-1), p.read_count,
        p.exact_diff, p.F1_diff, p.R2_diff, p.F2_diff, p.R1_diff,
        p.multi_diff]).astype(np.int32)
    stat_vals = [st.total_reads, st.total_mapped, st.total_paired,
                 st.total_paired_distance, st.read_length_sum]
    stat_words = np.asarray(
        [w for v in stat_vals for w in (v >> 30, v & ((1 << 30) - 1))],
        dtype=np.int32)   # int32-safe up to 2^60 per stat per host

    # one representative device per process: with devices > 1 the other
    # local chips already reduced into this host's planes (MultiDevice-
    # Evidence), so the cross-host collectives ride a [num_processes]
    # mesh regardless of chips-per-host
    by_proc = {}
    for d in jax.devices():
        by_proc.setdefault(d.process_index, d)
    devs = [by_proc[k] for k in sorted(by_proc)]
    rep = by_proc[process_id]
    mesh = Mesh(np.asarray(devs), ("hosts",))
    n = len(devs)
    local_dev = jax.device_put(jnp.asarray(local[None, :]), rep)
    garr = jax.make_array_from_single_device_arrays(
        (n, local.size), NamedSharding(mesh, P("hosts", None)), [local_dev])

    @jax.jit
    @functools.partial(jax.shard_map, mesh=mesh, in_specs=P("hosts", None),
                       out_specs=P(None))
    def allreduce(x):
        return jax.lax.psum(x[0], "hosts")

    reduced_g = allreduce(garr)
    reduced = np.asarray(
        [s.data for s in reduced_g.addressable_shards][0]).reshape(-1)

    # ---- events + discord sites: var-length all_gather ------------------
    # sizes are data-dependent, so processes first agree on the max via a
    # tiny psum-max, then pad to that and gather [used_words, stream...]
    aux_words = _serialize_aux(p, engine.inv_sites, engine.tnl_sites)
    len_dev = jax.device_put(jnp.asarray([[np.int32(aux_words.size)]]), rep)
    len_g = jax.make_array_from_single_device_arrays(
        (n, 1), NamedSharding(mesh, P("hosts", None)), [len_dev])

    @jax.jit
    @functools.partial(jax.shard_map, mesh=mesh, in_specs=P("hosts", None),
                       out_specs=P(None))
    def allmax(x):
        return jax.lax.pmax(x[0], "hosts")

    max_words = int(np.asarray(
        [s.data for s in allmax(len_g).addressable_shards][0])[0])
    ns = stat_words.size
    aux_local = np.zeros(1 + ns + max_words, dtype=np.int32)
    aux_local[0] = aux_words.size
    aux_local[1:1 + ns] = stat_words
    aux_local[1 + ns:1 + ns + aux_words.size] = aux_words
    aux_dev = jax.device_put(jnp.asarray(aux_local[None, :]), rep)
    aux_g = jax.make_array_from_single_device_arrays(
        (n, aux_local.size), NamedSharding(mesh, P("hosts", None)), [aux_dev])

    @jax.jit
    @functools.partial(jax.shard_map, mesh=mesh, in_specs=P("hosts", None),
                       out_specs=P(None, None), check_vma=False)
    def allgather(x):
        return jax.lax.all_gather(x[0], "hosts")   # [n_hosts, N], replicated

    gathered_g = allgather(aux_g)
    gathered = np.asarray(
        [s.data for s in gathered_g.addressable_shards][0])
    if gathered.ndim == 1:
        gathered = gathered.reshape(n, -1)

    if process_id != 0:
        jax.distributed.shutdown()
        return

    # ---- host 0: merge raw diffs + ONE finalize + call ------------------
    L1 = L + 1
    sizes = [4 * L, L, L1, L1, L1, L1, L1, L1]
    off = 0
    parts = []
    for s in sizes:
        parts.append(reduced[off:off + s])
        off += s
    p.acgt[:] = parts[0].reshape(4, L).astype(np.int32)     # raw point adds
    p.read_count[:] = np.minimum(parts[1], cfg.max_duplicate)
    p.exact_diff[:] = parts[2].astype(np.int32)
    p.F1_diff[:] = parts[3].astype(np.int32)
    p.R2_diff[:] = parts[4].astype(np.int32)
    p.F2_diff[:] = parts[5].astype(np.int32)
    p.R1_diff[:] = parts[6].astype(np.int32)
    p.multi_diff[:] = parts[7].astype(np.int32)
    # sum the per-host hi/lo stat pairs in Python (arbitrary precision)
    sums = [0] * 5
    for h in range(gathered.shape[0]):
        row = gathered[h]
        for k in range(5):
            sums[k] += (int(row[1 + 2 * k]) << 30) | int(row[2 + 2 * k])
    (st.total_reads, st.total_mapped, st.total_paired,
     st.total_paired_distance, st.read_length_sum) = sums
    p.break_point.clear()
    p.insert_map.clear()
    p.delete_map.clear()
    engine.inv_sites.clear()
    engine.tnl_sites.clear()
    for h in range(gathered.shape[0]):
        row = gathered[h]
        _decode_aux(row[1 + ns:], int(row[0]), p, engine.inv_sites,
                    engine.tnl_sites)
    engine.finalize()   # folds the merged diffs ONCE (cap-after-sum)

    block_depth = cal_block_read_depth(p, L)
    variants = identify_variants(cfg, engine.genome, p,
                                 idx.ref.ref_sequence_codes(), block_depth)
    if engine.inv_sites or engine.tnl_sites:
        from ..calling.caller import (identify_break_point_candidates,
                                      identify_sv)
        bp_cans = identify_break_point_candidates(
            p, engine.genome.two_genome_size, st.avg_read_length)
        if bp_cans and engine.inv_sites:
            variants = sorted(variants + identify_sv(
                p, engine.genome, bp_cans, engine.inv_sites, 3, block_depth,
                st.fragment_size, st.avg_read_length),
                key=lambda v: (v.gPos, v.VarType))
        if bp_cans and engine.tnl_sites:
            variants = sorted(variants + identify_sv(
                p, engine.genome, bp_cans, engine.tnl_sites, 4, block_depth,
                st.fragment_size, st.avg_read_length),
                key=lambda v: (v.gPos, v.VarType))
    with open(out_vcf, "w") as f:
        write_meta(f, cfg, engine.genome, VERSION_STR, cmd_line)
        write_variants(f, cfg, engine.genome, p, engine.ref_chars, variants)
    jax.distributed.shutdown()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--num", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--fasta", required=True)
    ap.add_argument("--reads", required=True)
    ap.add_argument("--reads2", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--devices", type=int, default=1,
                    help="local data-parallel chips per host (-devices N)")
    args = ap.parse_args()
    run_host(args.pid, args.num, args.coordinator, args.fasta, args.reads,
             args.out, "multihost-test", reads2=args.reads2,
             devices=args.devices)


if __name__ == "__main__":
    main()
