"""Stream fast-path edge cases: N-containing reads (2-bit packing can't
represent them -> host-oracle seeding + segment splitting) and reads
longer than the widest device bucket, checked against the pure-Python
host engine."""
import os
import time

import numpy as np
import pytest

from mapcaller.config import Config
from mapcaller.dna import decode
from mapcaller.index.fmindex import build_index
from mapcaller.io.fastq import iter_chunks
from mapcaller.io.sam import sam_headers
from mapcaller.pipeline.device_backend import DeviceBackend
from mapcaller.pipeline.engine import MappingEngine
from mapcaller.pipeline.read import ReadState
from mapcaller.pipeline.stream import run_stream_mapping


@pytest.fixture(scope="module")
def edge_files(toy_fasta, tmp_path_factory, rng):
    """Paired reads sampled from the toy genome with injected Ns and a
    few over-length reads."""
    from mapcaller.index.packer import iter_fasta
    d = tmp_path_factory.mktemp("edge")
    name, seq = next(iter_fasta(toy_fasta))
    L = len(seq)
    f1, f2 = str(d / "e1.fq"), str(d / "e2.fq")
    with open(f1, "w") as a, open(f2, "w") as b:
        for k in range(120):
            rlen = 300 if k % 17 == 0 else 100     # some > 256 bucket
            frag = rlen + 200
            p = int(rng.integers(0, L - frag))
            s1 = list(seq[p:p + rlen])
            from mapcaller.dna import revcomp_str
            s2 = list(revcomp_str(seq[p + frag - rlen:p + frag]))
            if k % 5 == 0:                          # inject Ns
                for _ in range(int(rng.integers(1, 4))):
                    s1[int(rng.integers(0, rlen))] = "N"
                s2[int(rng.integers(0, rlen))] = "N"
            q = "I" * rlen
            a.write(f"@e{k}/1\n{''.join(s1)}\n+\n{q}\n")
            b.write(f"@e{k}/2\n{''.join(s2)}\n+\n{q}\n")
    return f1, f2


def test_stream_matches_host_engine_on_edge_reads(toy_fasta, edge_files,
                                                  tmp_path):
    idx = build_index(toy_fasta)
    f1, f2 = edge_files

    # pure-Python host engine (no native, no device): the oracle
    cfg_h = Config(sam_file="x", vcf_file=str(tmp_path / "h.vcf"),
                   log_file=str(tmp_path / "h.log"))
    host = MappingEngine(idx, cfg_h, backend=None, use_native=False)
    host_sam = sam_headers(host.genome, "0.9.9.41")
    for ch in iter_chunks(f1, f2):
        host_sam.extend(host.process_chunk(
            [ReadState(r.header, r.seq, r.qual) for r in ch], True))
    host.finalize()

    # stream fast path (native + device + diff evidence)
    cfg_s = Config(sam_file="x", vcf_file=str(tmp_path / "s.vcf"),
                   log_file=str(tmp_path / "s.log"),
                   batch_size=64, stream_batch_size=64, max_read_len=256)
    backend = DeviceBackend(idx, cfg_s)
    stream = MappingEngine(idx, cfg_s, backend=backend)
    cfg_s.read_files1, cfg_s.read_files2 = [f1], [f2]
    parts = []
    run_stream_mapping(stream, cfg_s, time.time(), parts.append)
    stream.finalize()
    stream.materialize_profile()   # device evidence planes -> host arrays
    stream_sam = sam_headers(stream.genome, "0.9.9.41")
    stream_sam.extend("".join(parts).splitlines())

    assert stream_sam == host_sam
    assert np.array_equal(stream.profile.acgt, host.profile.acgt)
    assert np.array_equal(stream.profile.multi_hit, host.profile.multi_hit)
    for name in ("F1", "R2", "F2", "R1", "read_count"):
        assert np.array_equal(getattr(stream.profile, name),
                              getattr(host.profile, name)), name
    assert stream.profile.insert_map == host.profile.insert_map
    assert stream.profile.delete_map == host.profile.delete_map
    assert stream.profile.break_point == host.profile.break_point
    assert stream.stats.total_mapped == host.stats.total_mapped
    assert stream.stats.total_paired == host.stats.total_paired
