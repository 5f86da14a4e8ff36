"""Stream-ring hardening: the native parser slot ring is the contract
between the Python pipeline (in-flight device batches) and the C++
parser (host read data). A reused slot used to overwrite reads of a
batch still in flight SILENTLY (`slot_idx & 15`, the commit-60e7526 bug
class); the ring size is now exported (single source of truth), reuse
of a busy slot is refused loudly, and extreme depth x group settings
must still produce byte-identical output.

Ref analog: the reference bounds in-flight chunks with LibraryLock +
per-thread chunk ownership (ReadMapping.cpp:434-438).
"""
import os
import time

import pytest

from mapcaller.config import Config
from mapcaller.index.fmindex import build_index
from mapcaller.pipeline.engine import MappingEngine


DATA = os.path.join(os.path.dirname(__file__), "data", "subset")


def test_parser_slots_exported():
    from mapcaller.native import load_lib
    lib = load_lib()
    n = int(lib.mc_parser_slots())
    assert n >= 4   # the pipeline needs headroom for depth + group


def test_slot_reuse_refused(toy_fasta):
    """next_batch on a slot whose batch is still in flight must raise,
    not silently overwrite; slot_release frees it."""
    idx = build_index(toy_fasta)
    cfg = Config()
    eng = MappingEngine(idx, cfg, backend=None, use_native=True)
    nat = eng.native
    reads = b"@a\nACGTACGTACGTACGTACGT\n+\nIIIIIIIIIIIIIIIIIIII\n" * 64
    nat.set_input(reads, None, False)
    n, _ = nat.next_batch(0, 8)
    assert n == 8
    with pytest.raises(RuntimeError, match="slot 0 reused"):
        nat.next_batch(0, 8)
    nat.slot_release(0)
    n, _ = nat.next_batch(0, 8)
    assert n == 8
    # EOF leaves the slot free (no release needed)
    nat.slot_release(0)
    while True:
        n, _ = nat.next_batch(0, 8)
        nat.slot_release(0)
        if n == 0:
            break
    n, _ = nat.next_batch(0, 8)
    assert n == 0


@pytest.mark.parametrize("group,depth", [(20, 30), (16, 1), (8, 14)])
def test_depth_group_past_boundary(toy_fasta, tmp_path, group, depth):
    """Drive stream_pipeline_depth x stream_group past the former
    16-slot boundary: the pipeline must clamp (not wrap) and produce
    output byte-identical to the default settings. Pre-fix, group>=16
    silently mapped ZERO reads and group+depth>16 corrupted read data."""
    from mapcaller.pipeline.device_backend import DeviceBackend
    from mapcaller.pipeline.stream import run_stream_mapping

    idx = build_index(toy_fasta)

    def run(tag, **kw):
        cfg = Config(sam_file="x", vcf_file=str(tmp_path / f"{tag}.vcf"),
                     log_file=str(tmp_path / f"{tag}.log"),
                     stream_batch_size=512, **kw)
        cfg.read_files1 = [os.path.join(DATA, "sub_r1.fq.gz")]
        cfg.read_files2 = [os.path.join(DATA, "sub_r2.fq.gz")]
        eng = MappingEngine(idx, cfg, backend=DeviceBackend(idx, cfg))
        parts = []
        run_stream_mapping(eng, cfg, time.time(), parts.append)
        assert eng.stats.total_reads > 0   # group>=16 used to map zero
        return sorted("".join(parts).splitlines())

    want = run("base")
    got = run(f"g{group}d{depth}", stream_group=group,
              stream_pipeline_depth=depth)
    assert got == want
