#!/usr/bin/env python
"""Measure offline index-build peak RSS + wall time for a synthetic
genome of a given size (default 60 Mb). Pure host work — no device.

Usage: python scripts/build_rss.py [genome_mb] [--json OUT]
"""
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import numpy as np

    from mapcaller.index.fmindex import build_index
    from mapcaller.index.packer import PackedReference

    mb = float(sys.argv[1]) if len(sys.argv) > 1 else 60.0
    L = int(mb * 1e6)
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    ref = PackedReference(names=["chr1"], lengths=[L], offsets=[0],
                          codes=codes, holes=[])
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    t0 = time.time()
    idx = build_index(None, packed=ref)
    dt = time.time() - t0
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    out = {"genome_mb": mb, "build_s": round(dt, 1),
           "rss_before_gb": round(rss0, 2), "rss_peak_gb": round(rss, 2),
           "bytes_per_base": round(rss * 1e9 / L, 1),
           "sa_full_dtype": str(idx.sa_full.dtype) if idx.sa_full is not None
           else None}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
