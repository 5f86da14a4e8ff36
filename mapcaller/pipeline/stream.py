"""Stream mapping driver: native parsing + device seeding, double-buffered.

The hot loop never materializes per-read Python objects: the C++ runtime
parses FASTQ/FASTA batches (slot 0/1), hands the device a padded code
matrix, and consumes the flat seed arrays the device returns. While the
device seeds batch k+1, the host processes batch k (chain -> pair -> align
-> SAM -> PFM), mirroring the reference's reader-thread/worker overlap
(ref: ReadMapping.cpp:416-646).
"""
from __future__ import annotations

import gzip
import os
import sys
import time
from typing import Callable, Optional

import numpy as np

from ..config import Config


def _load_bytes(path: str) -> bytes:
    if path.endswith(".gz"):
        with open(path, "rb") as f:
            return gzip.decompress(f.read())
    with open(path, "rb") as f:
        return f.read()


# cfg.compact_factor == 0 (auto): enable x4 lane compaction with 131k
# stream batches when the input can fill enough of them that the drain
# tail amortizes. Compacted lanes refill from a queued-read pool so the
# scan cost tracks the MEAN lane trajectory instead of the max; seed
# sets stay bit-identical (test_fm_compact).
_COMPACT_AUTO_FACTOR = 4
_COMPACT_AUTO_LANES = 32768


def _estimate_records(buf: bytes) -> int:
    """Record-count estimate from an exact parse of a 256 KB prefix,
    scaled by total size (exact counting would touch the whole buffer)."""
    if not buf:
        return 0
    n = 1 << 18
    sample = buf[:n]
    if buf[:1] == b"@":
        nrec = sample.count(b"\n") // 4
    else:
        nrec = sample.count(b">")
    if len(buf) <= n:
        return nrec
    return int(nrec * (len(buf) / n))


def _resolve_auto_compaction(cfg: Config, be, buf1: bytes,
                             buf2) -> None:
    cfg.compact_factor = 1
    if not (getattr(be, "chain_enabled", False)
            and getattr(be, "_fm3_ok", False)
            and getattr(be, "index_shards", 0) <= 1
            and getattr(be, "n_devices", 1) == 1):
        return
    est = _estimate_records(buf1) + (_estimate_records(buf2)
                                     if buf2 is not None else 0)
    batch = _COMPACT_AUTO_FACTOR * _COMPACT_AUTO_LANES
    if est >= 6 * batch:
        cfg.compact_factor = _COMPACT_AUTO_FACTOR
        cfg.stream_batch_size = batch


def run_stream_mapping(engine, cfg: Config, t_start: float,
                       sam_sink: Optional[Callable[[str], None]] = None) -> None:
    """Requires engine.native and engine.backend. Updates engine.stats,
    engine.profile (in place via C++), engine.inv_sites/tnl_sites."""
    native = engine.native
    be = engine.backend
    _sp = os.environ.get("MC_STAGE_PROF")
    _pt = time.perf_counter() if _sp else 0.0

    def _mark(label):
        nonlocal _pt
        if _sp:
            now = time.perf_counter()
            sys.stderr.write(f"[stage-prof] pre {label}: {now - _pt:.2f}s\n")
            _pt = now
    use_device_evidence = (cfg.vcf_output and be.chain_enabled
                           and getattr(cfg, "device_evidence", True)
                           and getattr(be, "device_evidence_ok", True))
    if cfg.vcf_output:
        # slow-read evidence always accumulates in the host diff arrays
        engine.enable_diff_profile()
    _mark("enable_diff_profile")
    if use_device_evidence:
        from .device_profile import make_device_evidence
        engine.device_evidence = make_device_evidence(be, cfg,
                                                      engine.profile)
        _mark("make_device_evidence")
        native.set_ops_mode(True)
        # the C++ slow path writes host planes invisibly to Python:
        # register its dirtiness probe so the device merge can skip
        # its O(L) nonzero scans when every read stayed on device
        engine.profile.dirty_probes.append(native.host_planes_dirty)
    fold_ev = (engine.device_evidence
               if use_device_evidence and getattr(cfg, "fold_evidence", False)
               else None)
    stats_io = np.zeros(6, dtype=np.int64)
    stats_io[5] = engine.stats.avg_dist

    for lib in range(len(cfg.read_files1)):
        f1 = cfg.read_files1[lib]
        f2 = cfg.read_files2[lib] if lib < len(cfg.read_files2) else None
        pair_end = f2 is not None or cfg.pair_interleaved
        buf1 = _load_bytes(f1)
        buf2 = _load_bytes(f2) if f2 is not None else None
        if int(getattr(cfg, "compact_factor", 1)) == 0:
            _resolve_auto_compaction(cfg, be, buf1, buf2)
        fastq = buf1[:1] == b"@"
        native.set_input(buf1, buf2, cfg.pair_interleaved)
        _mark("load+set_input")

        # device kernels require batch % 32 == 0 (fm_search assertions)
        sb = -(-max(cfg.stream_batch_size, 256) // 32) * 32
        use_chain = getattr(be, "chain_enabled", True)
        # keep `depth` device batches in flight (16 parser slots bound
        # the batches whose host-side read data must stay alive); with
        # N data-parallel chips, at least N+1 so every chip stays busy
        # transfer grouping: one H2D + one D2H per `group_n` batches —
        # pays off on high-latency links.
        # Off under -shards: the sliced submit builds single-chip
        # kernels, which would silently bypass the sharded-index path
        # group_n > 8 would leave < 8 parser slots for in-flight depth
        # (and >= 16 would drive `depth` to zero: silent empty output)
        group_n = (min(8, max(1, int(getattr(cfg, "stream_group", 1))))
                   if use_chain and fold_ev is None
                   and getattr(be, "index_shards", 0) <= 1
                   and hasattr(be, "submit_chain_group") else 1)
        n_dev = getattr(be, "n_devices", 1)
        # cap so a full group pushed at depth-1 pending still fits the
        # native parser slot ring (exported: single source of truth);
        # a reused slot would overwrite host read data of a batch still
        # in flight — the native side now refuses with an error, and
        # this cap guarantees we never hit it
        n_slots = native.parser_slots
        depth = min(n_slots - 2, n_slots - group_n,
                    max(1, getattr(cfg, "stream_pipeline_depth", 2),
                        n_dev + 1, 2 * group_n,
                        group_n * (n_dev + 1) if n_dev > 1 else 0))
        from collections import deque
        slot = 0
        pending = deque()
        eof = False
        # MC_STAGE_PROF=1: per-stage wall-time accumulation (parse /
        # submit / collect [includes device wait] / host C++ / evidence)
        prof = ({"parse": 0.0, "submit": 0.0, "collect": 0.0,
                 "host_cpp": 0.0, "evidence": 0.0, "batches": 0}
                if os.environ.get("MC_STAGE_PROF") else None)
        pc = time.perf_counter
        while not eof or pending:
            while not eof and len(pending) < depth:
                t0 = pc() if prof is not None else 0.0
                if group_n > 1:
                    metas = []
                    while not eof and len(metas) < group_n:
                        n, maxlen = native.next_batch(slot, sb)
                        if n <= 0:
                            eof = True
                            break
                        metas.append((slot, n, maxlen))
                        slot = (slot + 1) % n_slots
                    if not metas:
                        break
                    bucket = next(
                        (b for b in be.BUCKETS
                         if b >= min(max(m[2] for m in metas), be.max_len)),
                        be.BUCKETS[-1])
                    parts = [native.batch_codes_packed(s, bucket, sb)
                             for s, _, _ in metas]
                    if prof is not None:
                        t1 = pc()
                        prof["parse"] += t1 - t0
                    tokens, group = be.submit_chain_group(parts, bucket,
                                                          pair_end)
                    if prof is not None:
                        prof["submit"] += pc() - t1
                    for (s, n, _), tok in zip(metas, tokens):
                        pending.append((s, n, tok, group))
                    continue
                n, maxlen = native.next_batch(slot, sb)
                if n <= 0:
                    eof = True
                    break
                bucket = next((b for b in be.BUCKETS
                               if b >= min(maxlen, be.max_len)), be.BUCKETS[-1])
                packed, rlens = native.batch_codes_packed(slot, bucket, sb)
                if prof is not None:
                    t1 = pc()
                    prof["parse"] += t1 - t0
                token = (be.submit_chain(packed, rlens, bucket,
                                         evidence=fold_ev, pair_end=pair_end)
                         if use_chain
                         else be.submit_packed(packed, rlens, bucket))
                if prof is not None:
                    prof["submit"] += pc() - t1
                pending.append((slot, n, token, None))
                slot = (slot + 1) % n_slots
            if not pending:
                break
            pslot, pn, ptoken, pgroup = pending.popleft()
            if pgroup is not None:
                be.resolve_chain_group(pgroup)
            if use_chain:
                if prof is not None and prof["batches"] == 0:
                    _mark("first-submit(s)")
                t0 = pc() if prof is not None else 0.0
                (cls, pd, mm, rplast, cscore, counts, rp, gp,
                 ln) = be.collect_chain(
                    ptoken, pn, lambda i, s=pslot: native.read_codes(s, i))
                if prof is not None:
                    t1 = pc()
                    prof["collect"] += t1 - t0
                    if prof["batches"] == 0:
                        _mark("first-collect")
                if cfg.device_extension:
                    sam_text, st = native.process_batch_cls_devdp(
                        pslot, pair_end, fastq, cls, pd, mm, rplast, cscore,
                        counts, rp, gp, ln, stats_io, cfg.use_nw)
                else:
                    sam_text, st = native.process_batch_cls(
                        pslot, pair_end, fastq, cls, pd, mm, rplast, cscore,
                        counts, rp, gp, ln, stats_io)
                if prof is not None:
                    t2 = pc()
                    prof["host_cpp"] += t2 - t1
                if engine.device_evidence is not None:
                    fbits = native.fetch_fast_bits()
                    engine.device_evidence.reconcile_batch(ptoken, fbits,
                                                           pair_end)
                    if prof is not None:
                        prof["evidence"] += pc() - t2
                if prof is not None:
                    prof["batches"] += 1
            else:
                counts, rp, gp, ln = be.collect_packed(
                    ptoken, pn, lambda i, s=pslot: native.read_codes(s, i))
                sam_text, st = native.process_batch(
                    pslot, pair_end, fastq, counts, rp, gp, ln, stats_io)
            native.slot_release(pslot)
            engine.inv_sites.extend(st["inv"])
            engine.tnl_sites.extend(st["tnl"])
            if sam_sink is not None and sam_text:
                sam_sink(sam_text)
            sys.stderr.write(
                f"\r{int(stats_io[0])} "
                f"{'paired-end' if pair_end else 'singled-end'} reads "
                f"processed in {int(time.time() - t_start)} seconds...")

        if prof is not None and prof["batches"]:
            import json
            sys.stderr.write("\n[stage-prof] " + json.dumps(
                {k: (round(v, 3) if isinstance(v, float) else v)
                 for k, v in prof.items()}) + "\n")

    s = engine.stats
    s.total_reads = int(stats_io[0])
    s.total_mapped = int(stats_io[1])
    s.total_paired = int(stats_io[2])
    s.total_paired_distance = int(stats_io[3])
    s.read_length_sum = int(stats_io[4])
    s.avg_dist = int(stats_io[5])
    sys.stderr.write("\n")
