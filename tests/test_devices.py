"""Production multi-device data parallelism (`-devices N`,
parallel/devices.py): the N-chip run must be BYTE-IDENTICAL to the
single-chip run — including when the PCR-duplicate gate binds, which
the per-shard-engine merge design cannot guarantee (see
parallel/distributed.py's documented divergence). Reference scale-out
analog: worker threads sharing one PFM, src/ReadMapping.cpp:735-736."""
import os
import time

import numpy as np
import pytest

from mapcaller.cli import parse_args
from mapcaller.config import Config
from mapcaller.dna import decode
from mapcaller.index.fmindex import build_index
from mapcaller.index.packer import PackedReference
from mapcaller.io.sam import sam_headers
from mapcaller.pipeline.engine import MappingEngine
from mapcaller.pipeline.stream import run_stream_mapping

NDEV = 4


def _write_fastq(path, reads):
    with open(path, "w") as f:
        for name, seq in reads:
            f.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")


def _make_dataset(tmp_path, n_pairs=1500, dup_block=24):
    """20 kb genome; background pairs + planted SNPs + one heavy PCR
    duplicate stack (dup_block identical pairs, spread through the file
    so they land in different stream batches => different devices)."""
    rng = np.random.default_rng(11)
    L = 20000
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    ref = PackedReference(["chr1"], [L], [0], codes, [])
    idx = build_index(None, packed=ref)
    comp = 3 - codes
    RL, frag = 100, 300

    def pair_at(p, mm_at=-1, alt=0):
        r1 = codes[p:p + RL].copy()
        if mm_at >= 0:
            r1[mm_at - p] = alt
        r2 = comp[p + frag - RL:p + frag][::-1]
        return decode(r1), decode(r2)

    entries = []
    for k in range(n_pairs):
        p = int(rng.integers(0, L - frag))
        entries.append(pair_at(p))
    for site in (3000, 9000, 15000):     # SNPs: 10 overlapping alt reads
        alt = (int(codes[site]) + 1) % 4
        for k in range(10):
            p = site - 12 - 4 * k
            entries.append(pair_at(p, mm_at=site, alt=alt))
    # PCR duplicate stack at a fixed start: the gate must reject all but
    # cfg.max_duplicate of these IN GLOBAL ORDER
    dup = pair_at(5000)
    step = max(1, len(entries) // dup_block)
    for j in range(dup_block):
        entries.insert(j * step, dup)
    r1 = [(f"p{i}/1", a) for i, (a, b) in enumerate(entries)]
    r2 = [(f"p{i}/2", b) for i, (a, b) in enumerate(entries)]
    f1 = str(tmp_path / "r1.fq")
    f2 = str(tmp_path / "r2.fq")
    _write_fastq(f1, r1)
    _write_fastq(f2, r2)
    return idx, f1, f2


def _run(idx, tmp_path, tag, f1, f2, n_devices):
    cfg = Config(vcf_file=str(tmp_path / f"{tag}.vcf"),
                 log_file=str(tmp_path / f"{tag}.log"),
                 batch_size=256, stream_batch_size=256, max_read_len=128,
                 devices=n_devices)
    if n_devices > 1:
        from mapcaller.parallel.devices import MultiDeviceBackend
        backend = MultiDeviceBackend(idx, cfg, n_devices)
        assert backend.n_devices == n_devices
    else:
        from mapcaller.pipeline.device_backend import DeviceBackend
        backend = DeviceBackend(idx, cfg)
    engine = MappingEngine(idx, cfg, backend=backend)
    cfg.read_files1, cfg.read_files2 = [f1], [f2]
    parts = []
    run_stream_mapping(engine, cfg, time.time(), parts.append)
    used = None
    if n_devices > 1:
        used = {d.id for (d, be) in zip(backend.devs, backend.bes)
                if be.n_oracle_reads >= 0}   # replicas constructed
    engine.finalize()
    sam = sam_headers(engine.genome, "test")
    sam.extend("".join(parts).splitlines())
    from mapcaller.runner import run_calling
    run_calling(engine, cfg, "test-devices")
    vcf = [l for l in open(cfg.vcf_file).read().splitlines()
           if not l.startswith("##")]
    return sam, vcf, engine, used


def test_multi_device_byte_parity(tmp_path):
    idx, f1, f2 = _make_dataset(tmp_path)
    sam1, vcf1, eng1, _ = _run(idx, tmp_path, "single", f1, f2, 1)
    samN, vcfN, engN, _ = _run(idx, tmp_path, "multi", f1, f2, NDEV)
    assert samN == sam1
    assert vcfN == vcf1
    assert len(vcf1) > 3          # header + >= 3 planted SNPs called
    assert engN.stats.total_reads == eng1.stats.total_reads
    assert engN.stats.total_mapped == eng1.stats.total_mapped


def test_multi_device_dup_gate_binds(tmp_path):
    """The dataset's duplicate stack must actually exercise the gate:
    read_count at the duplicated start saturates at cfg.max_duplicate,
    and the admitted evidence equals the sequential run's (already
    covered by byte-parity above; this guards the fixture)."""
    idx, f1, f2 = _make_dataset(tmp_path)
    _, _, eng, _ = _run(idx, tmp_path, "gate", f1, f2, NDEV)
    p = eng.profile
    assert p is not None
    assert int(p.read_count[5000]) == eng.cfg.max_duplicate


def test_cli_devices_flag():
    cfg = parse_args(["prog", "-i", "x", "-f", "a.fq", "-devices", "4"])
    assert cfg.devices == 4
    cfg = parse_args(["prog", "-i", "x", "-f", "a.fq", "-devices", "auto"])
    assert cfg.devices == 0


def test_devices_shards_exclusive(tmp_path):
    from mapcaller.runner import make_engine
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=4000).astype(np.uint8)
    idx = build_index(None, packed=PackedReference(
        ["c"], [4000], [0], codes, []))
    cfg = Config(devices=2, index_shards=2, backend="device")
    with pytest.raises(ValueError):
        make_engine(idx, cfg)
