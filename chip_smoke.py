#!/usr/bin/env python3
"""Smoke run of map+call on an NVIDIA GPU through the normal entry points.

    python chip_smoke.py                # one card: all phases below
    python chip_smoke.py --four-cards   # -devices 4 and -shards 4 vs one card

This process never imports JAX: each phase runs as a child process, one
at a time, so only one process ever holds the card. Phases (one card):

  1. card     nvidia-smi name + power limit; JAX must report a `gpu`.
  2. parity   the `gpu`-marked tests: each device kernel against its
              host oracle at the widths the CLI runs.
  3. e2e      the bench deployment: a seeded 4.6 Mb genome, its mutant
              and 1,000,000 paired 100 bp reads; `cli index`, then
              `cli ... -backend device` twice (cold, then with the
              persistent compile cache warm). Prints reads/s, map and
              call seconds, the prefix-skip depth K, and the measured
              peak device memory beside the capacity model's prediction.
  4. oracle   the first 10,000 pairs through `-backend device` and
              `-backend host`: SAM and VCF must be byte-identical (the
              VCF's ##command_line meta line names the backend and is
              the one line left out of the comparison).

The last line of stdout is the JSON result; any failed phase exits
non-zero without it.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, ".smoke_data")       # git-ignored


class PhaseFailed(Exception):
    pass


def _run(cmd, timeout, env=None, log=None):
    """Run a child from the repo root; on failure print its tail and
    raise. Returns its stdout."""
    full_env = dict(os.environ, **(env or {}))
    t0 = time.time()
    p = subprocess.run(cmd, cwd=ROOT, env=full_env, capture_output=True,
                       text=True, timeout=timeout)
    if log is not None:
        with open(log, "w") as f:
            f.write(p.stdout + "\n--- stderr ---\n" + p.stderr)
    if p.returncode != 0:
        sys.stdout.write(p.stdout[-4000:] + "\n" + p.stderr[-6000:] + "\n")
        raise PhaseFailed(f"{' '.join(cmd[:4])} ... exited {p.returncode} "
                          f"after {time.time() - t0:.1f}s")
    return p.stdout


def card():
    """-> JAX's view of the devices; fails unless they are GPUs."""
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], 60)
    for line in smi.strip().splitlines():
        print(f"[card] {line.strip()}")
    probe = _run([sys.executable, "-c",
                  "import jax, json; d = jax.devices(); print(json.dumps("
                  "{'platform': d[0].platform, 'kind': d[0].device_kind, "
                  "'count': len(d)}))"], 300)
    dev = json.loads(probe.strip().splitlines()[-1])
    print(f"[card] jax: {dev}")
    if dev["platform"] != "gpu":
        raise PhaseFailed(f"JAX found no GPU (platform {dev['platform']})")
    return dev


def kernel_parity():
    out = _run([sys.executable, "-m", "pytest", "-q", "-rA", "-m", "gpu",
                "-p", "no:cacheprovider", "tests/test_gpu_parity.py"], 900,
               env={"JAX_PLATFORMS": "cuda"})
    lines = out.strip().splitlines()
    for line in lines:
        if line.startswith(("PASSED", "FAILED", "SKIPPED", "ERROR")):
            print(f"[parity] {line}")
    print(f"[parity] {lines[-1]}")
    if "skipped" in lines[-1] or "passed" not in lines[-1]:
        raise PhaseFailed("gpu parity tests did not all run and pass")


def fixtures(n_pairs):
    """The bench deployment's genome, mutant and reads (bench.py seeds)
    and its index through `cli index` (set-up time)."""
    t0 = time.time()
    out = _run([sys.executable, "-c",
                "import bench, json; print(json.dumps(bench.ensure_fixtures("
                f"{DATA!r}, {n_pairs})))"], 900)
    fa, r1, r2 = json.loads(out.strip().splitlines()[-1])
    prefix = f"{DATA}/mci"
    if not os.path.exists(prefix + ".mci.json"):
        _run([sys.executable, "-m", "mapcaller.cli", "index", fa, prefix],
             600)
    print(f"[setup] genome + {n_pairs} pairs + index in "
          f"{time.time() - t0:.1f}s")
    return prefix, r1, r2


def map_call(prefix, r1, r2, tag, extra=(), backend="device",
             timeout=900):
    """One CLI map+call run; -> (sam, vcf, metrics of the log's JSON
    summary line)."""
    out = f"{DATA}/{tag}"
    if os.path.exists(out + ".log"):      # the CLI appends to its log
        os.remove(out + ".log")
    t0 = time.time()
    _run([sys.executable, "-m", "mapcaller.cli", "-i", prefix, "-f", r1,
          "-f2", r2, "-sam", out + ".sam", "-vcf", out + ".vcf",
          "-log", out + ".log", "-backend", backend, *extra], timeout,
         log=out + ".stderr")
    wall = time.time() - t0
    with open(out + ".log") as f:
        metrics = json.loads([ln for ln in f if ln.startswith("{")][-1])
    metrics["process_seconds"] = round(wall, 3)
    return out + ".sam", out + ".vcf", metrics


def _same_outputs(a, b):
    """SAM byte-identical; VCF byte-identical but for ##command_line."""
    with open(a[0], "rb") as f, open(b[0], "rb") as g:
        sam_ok = f.read() == g.read()
    with open(a[1], "rb") as f, open(b[1], "rb") as g:
        va, vb = ([ln for ln in h.read().split(b"\n")
                   if not ln.startswith(b"##command_line=")] for h in (f, g))
    return sam_ok, va == vb, len(va)


def _report(tag, m):
    dev = m.get("device", {})
    peak = dev.get("peak_bytes_in_use") or []
    print(f"[{tag}] reads={m['total_reads']} mapped={m['mapped']} "
          f"reads/s={m['reads_per_sec']} map_s={m['mapping_seconds']} "
          f"call_s={m.get('calling_seconds')} total_s={m['total_seconds']} "
          f"process_s={m['process_seconds']}")
    print(f"[{tag}] device={dev.get('device_kind')} K={dev.get('prefix_skip_k')} "
          f"peak_bytes_in_use={peak} predicted_bytes={dev.get('predicted_bytes')} "
          f"budget_bytes={dev.get('budget_bytes')}")


def end_to_end(prefix, r1, r2):
    cold = map_call(prefix, r1, r2, "e2e_cold")
    _report("e2e cold", cold[2])
    warm = map_call(prefix, r1, r2, "e2e_warm")
    _report("e2e warm", warm[2])
    if cold[2]["total_reads"] != 2 * _count_pairs(r1):
        raise PhaseFailed("the run did not process every read")
    sam_ok, vcf_ok, _ = _same_outputs(cold, warm)
    if not (sam_ok and vcf_ok):
        raise PhaseFailed("cold and warm runs differ")
    print(f"[e2e] compile + cache set-up ~ "
          f"{cold[2]['total_seconds'] - warm[2]['total_seconds']:.1f}s "
          f"(cold minus warm total)")


def _count_pairs(r1):
    with open(r1, "rb") as f:
        return sum(1 for _ in f) // 4


def _head(src, n_pairs, dst):
    with open(src) as f, open(dst, "w") as g:
        for i, line in enumerate(f):
            if i >= 4 * n_pairs:
                break
            g.write(line)
    return dst


def oracle(prefix, r1, r2, n_pairs):
    s1 = _head(r1, n_pairs, f"{DATA}/o1_{n_pairs}.fq")
    s2 = _head(r2, n_pairs, f"{DATA}/o2_{n_pairs}.fq")
    dev = map_call(prefix, s1, s2, "oracle_device")
    host = map_call(prefix, s1, s2, "oracle_host", backend="host",
                    timeout=1200)
    sam_ok, vcf_ok, n = _same_outputs(dev, host)
    print(f"[oracle] {n_pairs} pairs: device vs host SAM identical={sam_ok} "
          f"VCF identical={vcf_ok} ({n} VCF lines); device "
          f"{dev[2]['total_seconds']}s, host {host[2]['total_seconds']}s")
    if not (sam_ok and vcf_ok):
        raise PhaseFailed("device output differs from the host oracle")


def four_cards(prefix, r1, r2):
    one = map_call(prefix, r1, r2, "cards1")
    _report("1 card", one[2])
    for flag in ("-devices", "-shards"):
        run = map_call(prefix, r1, r2, f"cards4{flag}", extra=(flag, "4"))
        _report(f"{flag} 4", run[2])
        sam_ok, vcf_ok, _ = _same_outputs(one, run)
        print(f"[{flag} 4] vs 1 card: SAM identical={sam_ok} "
              f"VCF identical={vcf_ok}")
        if not (sam_ok and vcf_ok):
            raise PhaseFailed(f"{flag} 4 output differs from one card")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only -devices 4 and -shards 4 against one card")
    ap.add_argument("--pairs", type=int, default=500_000,
                    help="read pairs of the end-to-end run")
    ap.add_argument("--oracle-pairs", type=int, default=10_000)
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "mapcaller")):
        sys.exit("chip_smoke.py must run from a checkout of the repository")
    t0 = time.time()
    try:
        dev = card()
        if args.four_cards:
            if dev["count"] < 4:
                raise PhaseFailed(f"--four-cards needs 4 GPUs, JAX sees "
                                  f"{dev['count']}")
            four_cards(*fixtures(args.pairs))
        else:
            kernel_parity()
            prefix, r1, r2 = fixtures(args.pairs)
            end_to_end(prefix, r1, r2)
            oracle(prefix, r1, r2, args.oracle_pairs)
    except (PhaseFailed, subprocess.TimeoutExpired, OSError) as e:
        print(f"[fail] {e}")
        sys.exit(1)
    print(f"[done] {time.time() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {"platform": dev["platform"],
                                             "kind": dev["kind"],
                                             "count": dev["count"]}}))


if __name__ == "__main__":
    main()
