"""Multi-host scale-out: data-parallel mapping + evidence reduction.

The reference is single-node pthreads with four mutexes
(ref: src/main.cpp:27; SURVEY section 2c). The data-parallel replacement
keeps every accumulator a pure commutative reduction, so scale-out is:

  * each host maps a shard of the read stream (its own chips seed via
    the replicated device FM-index; see pipeline/stream.py),
  * evidence lives in diff arrays / count planes (profile.py), which
    reduce by ELEMENTWISE SUM — on a pod slice that is one psum over
    ICI (jnp arrays), across hosts one allreduce over DCN
    (jax.distributed / multi-process jnp.psum); the sparse event maps
    (indel seqs, breakpoints) reduce by counter-dict merge,
  * saturation (MaxAlleleCount, dup cap) is applied AFTER the global
    reduction — for pure +1 streams cap-after-sum equals the
    reference's per-increment caps, so the merged result is what a
    single sequential run over all reads would produce.

    Known divergence: the PCR-duplicate gate (profile.py update_profile,
    ref: AlignmentProfile.cpp:76 — skip a read's evidence entirely once
    read_count[g_start] >= max_duplicate) is applied per shard BEFORE
    the merge, so up to n_hosts * max_duplicate same-start reads can
    contribute evidence where a sequential run admits max_duplicate.
    The merged read_count itself is capped at max_duplicate below, so
    the VCF RC field matches; per-base allele depths can exceed the
    sequential run's on duplicate-heavy data. To preserve the gate
    exactly, shard reads so same-start duplicates co-locate (e.g. hash
    by mate-1 name) — the default round-robin sharding does not.
  * the variant-calling scan is genome-sharded (embarrassingly parallel
    in _identify_variants_vec) with gap/CNV runs stitched at shard
    boundaries by construction (the RLE is computed on the full state
    vector of the owning shard plus its boundary run carry).

This module provides the single-process form of that reduction — N
engines standing in for N hosts — which is also the code path the
multi-process deployment calls per-host before the collective.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..pipeline.engine import MappingEngine
from ..pipeline.profile import MAX_ALLELE_COUNT


def merge_engines(engines: List[MappingEngine]) -> MappingEngine:
    """Reduce per-host evidence into engines[0] (the 'root host').

    Must be called BEFORE any engine's finalize(): diff arrays and point
    counts are merged raw, then the root finalizes once, so saturation
    happens exactly once over global totals."""
    for e in engines:
        if getattr(e, "device_evidence", None) is not None:
            # pull raw (unfolded, uncapped) diffs so saturation happens
            # exactly once after the global reduction below
            e.device_evidence.download_raw_into(e.profile)
            e.device_evidence = None
    root = engines[0]
    rp = root.profile
    for e in engines[1:]:
        p = e.profile
        if rp is not None and p is not None:
            rp.acgt += p.acgt                       # mismatch point adds
            if rp.F1_diff is not None and p.F1_diff is not None:
                for name in ("F1_diff", "R2_diff", "F2_diff", "R1_diff",
                             "multi_diff", "exact_diff"):
                    getattr(rp, name)[:] += getattr(p, name)
            else:
                for name in ("F1", "R2", "F2", "R1"):
                    getattr(rp, name)[:] += getattr(p, name)
                rp.multi_hit += p.multi_hit
                np.minimum(rp.multi_hit, MAX_ALLELE_COUNT, out=rp.multi_hit)
            rp.read_count += p.read_count
            # cap at the configured dup gate (ref: main.cpp:240-243 caps
            # -dup at 15; the gate itself is cfg.max_duplicate)
            np.minimum(rp.read_count, root.cfg.max_duplicate,
                       out=rp.read_count)
            for pos, cnt in p.break_point.items():
                rp.break_point[pos] = rp.break_point.get(pos, 0) + cnt
            for src, dst in ((p.insert_map, rp.insert_map),
                             (p.delete_map, rp.delete_map)):
                for pos, inner in src.items():
                    d = dst.setdefault(pos, {})
                    for seq, cnt in inner.items():
                        d[seq] = d.get(seq, 0) + cnt
        s, rs = e.stats, root.stats
        rs.total_reads += s.total_reads
        rs.total_mapped += s.total_mapped
        rs.total_paired += s.total_paired
        rs.total_paired_distance += s.total_paired_distance
        rs.read_length_sum += s.read_length_sum
        root.inv_sites.extend(e.inv_sites)
        root.tnl_sites.extend(e.tnl_sites)
    if rp is not None and rp.F1_diff is None:
        # plane mode: acgt merged above may exceed the cap
        np.minimum(rp.acgt, MAX_ALLELE_COUNT, out=rp.acgt)
    root.finalize()
    return root
