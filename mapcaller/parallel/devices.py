"""Production multi-device data parallelism: `-devices N` in the CLI.

The reference scales out with `iThreadNum` pthread workers that share
one PFM under mutexes (ref: src/ReadMapping.cpp:735-736, main.cpp:27).
The production shape for ONE HOST with N devices:

  * the FM-index (occ rows / 3-step table / SA / text words) is
    REPLICATED into every chip's HBM — data parallelism over reads,
    zero inter-chip traffic during mapping,
  * stream batches are submitted ROUND-ROBIN across the chips; each
    chip runs the full single-chip production kernel (lockstep occ3
    seed scan, device chaining/classification, tier reruns, overflow
    fallbacks — pipeline/device_backend.py, unchanged),
  * the host C++ leg processes batches STRICTLY IN SUBMISSION ORDER
    through the one native engine. This is the load-bearing design
    decision: the PCR-duplicate gate (AlignmentProfile.cpp:76) is a
    sequential per-start counter, SAM records stream in input order,
    and the pairing/rescue state is per-batch — so the N-device run
    is BYTE-IDENTICAL to the single-device run by construction, not
    just when the gate happens not to bind (contrast the per-shard
    engine merge in parallel/distributed.py, which documents its
    dup-gate divergence),
  * fast-read evidence accumulates in per-chip HBM planes
    (pipeline/device_profile.py); the admit bitmask the host produces
    for a batch is reconciled on the chip that mapped that batch; the
    N plane sets reduce ONCE at finalize (commutative scatter-adds,
    cap-after-sum — same proof as parallel/distributed.py).

Why not shard_map over a dp mesh axis? A single shard_mapped program
would lockstep all chips onto one batch schedule and lose the per-batch
tier-rerun/oracle-fallback machinery; read data parallelism needs no
collective until the final plane reduction, so independent per-chip
programs are both faster (no cross-chip barrier per batch) and exactly
the production single-chip code. The mesh/shard_map paths remain the
production shape where the INDEX itself must be sharded (`-shards N`,
parallel/sharded_index.py / big_index.py) and for the multi-host
evidence psum (parallel/multihost.py).
"""
from __future__ import annotations

import functools
from typing import List, Optional

import jax
import numpy as np

from ..config import Config
from ..index.fmindex import FMIndex
from ..pipeline.device_backend import DeviceBackend
from ..pipeline.device_profile import DeviceEvidence, DevicePlanes


class MultiDeviceBackend:
    """N per-device DeviceBackend replicas with the same submit/collect
    contract as one DeviceBackend; tokens carry the owning device."""

    is_multi_device = True

    def __init__(self, idx: FMIndex, cfg: Config, n_devices: int):
        # local_devices, not devices: under jax.distributed the global
        # list includes other hosts' (non-addressable) chips — this
        # backend is the per-host scale axis and composes with the
        # multi-host psum (parallel/multihost.py run_host(devices=N))
        devs = jax.local_devices()
        if n_devices > len(devs):
            raise ValueError(
                f"-devices {n_devices} but only {len(devs)} local "
                f"device(s) visible")
        self.idx = idx
        self.cfg = cfg
        self.devs = devs[:n_devices]
        self.bes: List[DeviceBackend] = []
        for d in self.devs:
            with jax.default_device(d):
                self.bes.append(DeviceBackend(idx, cfg))
        self._rr = 0

    # -- contract surface mirrored from the per-device backend ----------
    @property
    def n_devices(self) -> int:
        return len(self.bes)

    @property
    def BUCKETS(self):
        return self.bes[0].BUCKETS

    @property
    def max_len(self):
        return self.bes[0].max_len

    @property
    def batch(self):
        return self.bes[0].batch

    @property
    def chain_enabled(self):
        return self.bes[0].chain_enabled

    @property
    def device_evidence_ok(self):
        return all(be.device_evidence_ok for be in self.bes)

    @property
    def index_shards(self):
        return 0

    @property
    def big_x64(self):
        return False

    @property
    def n_tier_reruns(self):
        return sum(be.n_tier_reruns for be in self.bes)

    @property
    def n_full_fallbacks(self):
        return sum(be.n_full_fallbacks for be in self.bes)

    @property
    def n_oracle_reads(self):
        return sum(be.n_oracle_reads for be in self.bes)

    @property
    def chain_ctx(self):
        return self.bes[0].chain_ctx

    @property
    def fm(self):
        return self.bes[0].fm

    @property
    def fm3(self):
        return self.bes[0].fm3

    def device_report(self) -> dict:
        return self.bes[0].device_report()

    # -- round-robin submission, owner-routed collection -----------------
    def _next(self) -> int:
        i = self._rr
        self._rr = (self._rr + 1) % len(self.bes)
        return i

    def submit_chain(self, packed: np.ndarray, rlens: np.ndarray,
                     bucket: int, tier: int = 2, evidence=None,
                     pair_end: bool = False):
        i = self._next()
        ev = evidence.sub(i) if evidence is not None else None
        with jax.default_device(self.devs[i]):
            return (i, self.bes[i].submit_chain(
                packed, rlens, bucket, tier, evidence=ev,
                pair_end=pair_end))

    def collect_chain(self, token, n: int, read_codes_fn):
        i, inner = token
        with jax.default_device(self.devs[i]):
            return self.bes[i].collect_chain(inner, n, read_codes_fn)

    def submit_chain_group(self, parts, bucket: int, pair_end: bool = False):
        """Whole groups round-robin across chips (one H2D + one D2H per
        group per chip); member tokens carry the owning device."""
        i = self._next()
        with jax.default_device(self.devs[i]):
            tokens, group = self.bes[i].submit_chain_group(parts, bucket,
                                                           pair_end)
        return [(i, t) for t in tokens], group

    @staticmethod
    def resolve_chain_group(group) -> None:
        DeviceBackend.resolve_chain_group(group)

    def submit_packed(self, packed: np.ndarray, rlens: np.ndarray,
                      bucket: int, tier: int = 9):
        i = self._next()
        with jax.default_device(self.devs[i]):
            return (i, self.bes[i].submit_packed(packed, rlens, bucket,
                                                 tier))

    def collect_packed(self, token, n: int, read_codes_fn):
        i, inner = token
        with jax.default_device(self.devs[i]):
            return self.bes[i].collect_packed(inner, n, read_codes_fn)

    # -- ReadState-list API (non-stream fallback path) -------------------
    def submit(self, codes_list: List[np.ndarray]):
        pending = []
        B = self.batch
        for lo in range(0, len(codes_list), B):
            i = self._next()
            with jax.default_device(self.devs[i]):
                pending.append((i, self.bes[i]._submit_one(
                    codes_list[lo:lo + B])))
        return pending

    def collect(self, pending) -> List[tuple]:
        out: List[tuple] = []
        for i, item in pending:
            with jax.default_device(self.devs[i]):
                out.extend(self.bes[i]._collect_one(item))
        return out

    def seed_batch(self, codes_list: List[np.ndarray]) -> List[tuple]:
        return self.collect(self.submit(codes_list))


@functools.lru_cache(maxsize=None)
def _plane_add_kernel(L: int):
    def add(a: DevicePlanes, b: DevicePlanes) -> DevicePlanes:
        return DevicePlanes(acgt=a.acgt + b.acgt,
                            exact_diff=a.exact_diff + b.exact_diff,
                            f_diff=a.f_diff + b.f_diff,
                            multi_diff=a.multi_diff + b.multi_diff,
                            L=L)

    return jax.jit(add, donate_argnums=(0,))


class MultiDeviceEvidence(DeviceEvidence):
    """Per-chip HBM evidence planes with owner-routed reconciliation.

    Behaves as the primary chip's DeviceEvidence (finalize / scan /
    column fetch / gVCF blocks all run on device 0); the secondary
    chips' planes transfer to device 0 and reduce ONCE before the first
    finalize. The reduction is a pure sum of +1/-1 diff endpoints and
    point counts, so cap-after-sum equals a sequential run's caps
    (parallel/distributed.py proof; ref caps: AlignmentProfile.cpp:41).
    """

    def __init__(self, mbe: MultiDeviceBackend, cfg, host_profile):
        super().__init__(mbe.bes[0], cfg, host_profile)
        self.mbe = mbe
        self.secondaries: List[DeviceEvidence] = []
        for d, be in zip(mbe.devs[1:], mbe.bes[1:]):
            with jax.default_device(d):
                self.secondaries.append(DeviceEvidence(be, cfg,
                                                       host_profile))
        self._sec_merged = False

    def sub(self, i: int) -> DeviceEvidence:
        return self if i == 0 else self.secondaries[i - 1]

    def reconcile_batch(self, token, fast_bits: np.ndarray,
                        pair_end: bool) -> None:
        i, inner = token
        tgt = self.sub(i)
        with jax.default_device(self.mbe.devs[i]):
            DeviceEvidence.reconcile_batch(tgt, inner, fast_bits, pair_end)

    def apply_batch(self, token, fast_bits: np.ndarray,
                    pair_end: bool) -> None:
        if isinstance(token, tuple) and len(token) == 2 \
                and isinstance(token[0], int):
            i, inner = token
            tgt = self.sub(i)
            with jax.default_device(self.mbe.devs[i]):
                DeviceEvidence.apply_batch(tgt, inner, fast_bits, pair_end)
            return
        DeviceEvidence.apply_batch(self, token, fast_bits, pair_end)

    def _merge_secondaries(self) -> None:
        if self._sec_merged:
            return
        self._sec_merged = True
        prim = self.mbe.devs[0]
        add = _plane_add_kernel(self.L)
        for s in self.secondaries:
            with jax.default_device(prim):
                moved = jax.device_put(s.planes, prim)
                self.planes = add(self.planes, moved)
            s.planes = None

    def finalize(self):
        self._merge_secondaries()
        return DeviceEvidence.finalize(self)

    def download_raw_into(self, profile) -> None:
        self._merge_secondaries()
        DeviceEvidence.download_raw_into(self, profile)
