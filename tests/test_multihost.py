"""Multi-host rehearsal: 2 local processes, jax.distributed on the CPU
backend, per-host input shards, ONE cross-host psum of the evidence
planes — the merged VCF must be byte-identical to a 1-process run."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _write_fixtures(tmp_path):
    sys.path.insert(0, REPO)
    from mapcaller.dna import decode
    rng = np.random.default_rng(11)
    L = 6000
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    fa = tmp_path / "mh.fa"
    with open(fa, "w") as f:
        f.write(">chr1\n")
        s = decode(codes)
        for i in range(0, L, 70):
            f.write(s[i:i + 70] + "\n")
    reads = []
    RL = 70
    for p in range(0, L - RL, 18):
        c = codes[p:p + RL].copy()
        reads.append(c)
    # three SNP pileups + one deletion pileup (slow path + indel event)
    for site in (1200, 2600, 4300):
        alt = (int(codes[site]) + 1) % 4
        for k in range(8):
            p = site - 12 - 5 * k
            c = codes[p:p + RL].copy()
            c[site - p] = alt
            reads.append(c)
    for k in range(8):
        p = 3500 - 20 - 3 * k
        c = np.concatenate([codes[p:3500], codes[3502:3502 + RL]])[:RL]
        reads.append(c)
    fq = tmp_path / "mh.fq"
    with open(fq, "w") as f:
        for i, c in enumerate(reads):
            f.write(f"@m{i}\n{decode(c)}\n+\n{'I' * len(c)}\n")
    return str(fa), str(fq)


def _write_pe_fixtures(tmp_path):
    """Paired-end fixture: background pair tiling + SNP pileups on
    mate 1 + a deletion pileup (host slow path through the C++ engine)."""
    sys.path.insert(0, REPO)
    from mapcaller.dna import decode
    rng = np.random.default_rng(17)
    L = 8000
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    comp = 3 - codes
    fa = tmp_path / "pe.fa"
    with open(fa, "w") as f:
        f.write(">chr1\n")
        s = decode(codes)
        for i in range(0, L, 70):
            f.write(s[i:i + 70] + "\n")
    RL, frag = 100, 300
    pairs = []

    def add(p, r1=None):
        if r1 is None:
            r1 = codes[p:p + RL].copy()
        pairs.append((decode(r1), decode(comp[p + frag - RL:p + frag][::-1])))

    for p in range(0, L - frag - 10, 22):
        add(p)
    for site in (2000, 5500):
        alt = (int(codes[site]) + 1) % 4
        for k in range(8):
            p = site - 12 - 4 * k
            r1 = codes[p:p + RL].copy()
            r1[site - p] = alt
            add(p, r1)
    for k in range(8):
        p = 4000 - 20 - 3 * k
        r1 = np.concatenate([codes[p:4000], codes[4002:4002 + RL]])[:RL]
        add(p, r1)
    f1, f2 = tmp_path / "pe_r1.fq", tmp_path / "pe_r2.fq"
    for path, mate in ((f1, 0), (f2, 1)):
        with open(path, "w") as f:
            for i, pr in enumerate(pairs):
                f.write(f"@p{i}/{mate + 1}\n{pr[mate]}\n+\n{'I' * RL}\n")
    return str(fa), str(f1), str(f2)


def _launch(n, fasta, reads, out, port, reads2=None, devices=1):
    procs = []
    for pid in range(n):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={devices}")
        env.pop("JAX_NUM_PROCESSES", None)
        cmd = [sys.executable, "-m", "mapcaller.parallel.multihost",
               "--pid", str(pid), "--num", str(n),
               "--coordinator", f"127.0.0.1:{port}",
               "--fasta", fasta, "--reads", reads, "--out", out,
               "--devices", str(devices)]
        if reads2 is not None:
            cmd += ["--reads2", reads2]
        procs.append(subprocess.Popen(
            cmd, cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = [p.communicate(timeout=420) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]


def test_two_process_collective_vcf_matches_single(tmp_path):
    fasta, reads = _write_fixtures(tmp_path)
    single = str(tmp_path / "single.vcf")
    merged = str(tmp_path / "merged.vcf")
    _launch(1, fasta, reads, single, _free_port())
    _launch(2, fasta, reads, merged, _free_port())
    with open(single, "rb") as f1, open(merged, "rb") as f2:
        a, b = f1.read(), f2.read()
    assert a == b and len(a) > 200
    body = [l for l in a.decode().splitlines() if not l.startswith("#")]
    types = {l.split("TYPE=")[1].split("\t")[0].split(";")[0]
             for l in body if "TYPE=" in l}
    assert "snv" in types and "del" in types, types


def test_two_process_paired_end_production_path(tmp_path):
    """VERDICT r3 #3: the multi-host harness must run the production
    engine (C++ host path + device kernels + raw-diff psum), paired-end,
    and the 2-process VCF must be byte-identical to the 1-process run."""
    fasta, r1, r2 = _write_pe_fixtures(tmp_path)
    single = str(tmp_path / "pe_single.vcf")
    merged = str(tmp_path / "pe_merged.vcf")
    _launch(1, fasta, r1, single, _free_port(), reads2=r2)
    _launch(2, fasta, r1, merged, _free_port(), reads2=r2)
    with open(single, "rb") as f1, open(merged, "rb") as f2:
        a, b = f1.read(), f2.read()
    assert a == b and len(a) > 200
    body = [l for l in a.decode().splitlines() if not l.startswith("#")]
    types = {l.split("TYPE=")[1].split("\t")[0].split(";")[0]
             for l in body if "TYPE=" in l}
    assert "snv" in types and "del" in types, types


def test_two_process_two_device_composition(tmp_path):
    """VERDICT r4 #7: the scale-out axes compose — M host processes x
    N local data-parallel devices each (the reference's threads compose
    trivially, ReadMapping.cpp:735-736). A 2-process x 2-virtual-device
    paired-end run must be byte-identical to 1 process x 1 device: each
    host's chips round-robin its batches with an ordered host leg
    (dup gate by construction), per-chip planes reduce locally, then
    the raw planes psum across hosts exactly as with one chip/host."""
    fasta, r1, r2 = _write_pe_fixtures(tmp_path)
    single = str(tmp_path / "c_single.vcf")
    merged = str(tmp_path / "c_merged.vcf")
    _launch(1, fasta, r1, single, _free_port(), reads2=r2)
    _launch(2, fasta, r1, merged, _free_port(), reads2=r2, devices=2)
    with open(single, "rb") as f1, open(merged, "rb") as f2:
        a, b = f1.read(), f2.read()
    assert a == b and len(a) > 200
    body = [l for l in a.decode().splitlines() if not l.startswith("#")]
    types = {l.split("TYPE=")[1].split("\t")[0].split(";")[0]
             for l in body if "TYPE=" in l}
    assert "snv" in types and "del" in types, types


def test_aux_stream_roundtrip_long_indels_and_counts():
    """The var-length aux stream handles what the old int32-pair packing
    crashed on: indel seqs >8 bp and arbitrarily large counts."""
    sys.path.insert(0, REPO)
    from mapcaller.parallel.multihost import _decode_aux, _serialize_aux

    class P:
        pass

    p = P()
    long_seq = "ACGTACGTACGTACGTACGTA"          # 21 bp > old 8 bp limit
    p.break_point = {123456: 3, 99: 200000}     # count >> old repeat model
    p.insert_map = {500: {long_seq: 7, "AC": 1}}
    p.delete_map = {700: {"G" * 40: 2}}
    inv = [(10, 4), (20, 5)]
    tnl = [(30, 6)]
    words = _serialize_aux(p, inv, tnl)

    q = P()
    q.break_point, q.insert_map, q.delete_map = {}, {}, {}
    inv2, tnl2 = [], []
    _decode_aux(words, words.size, q, inv2, tnl2)
    assert q.break_point == p.break_point
    assert q.insert_map == p.insert_map
    assert q.delete_map == p.delete_map
    assert inv2 == inv and tnl2 == tnl
