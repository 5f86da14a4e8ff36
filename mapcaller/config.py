"""Run configuration.

Typed equivalent of the reference's global flag set and defaults
(ref: src/main.cpp:159-191, src/structure.h:197-221).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class Config:
    # input
    index_prefix: Optional[str] = None          # -i
    ref_fasta: Optional[str] = None             # -r (build throwaway index)
    read_files1: List[str] = dataclasses.field(default_factory=list)   # -f
    read_files2: List[str] = dataclasses.field(default_factory=list)   # -f2
    pair_interleaved: bool = False              # -p / -pair

    # mapping parameters (defaults: main.cpp:159-191)
    n_threads: int = 16                         # -t
    max_pos_diff: int = 30                      # -indel  (max indel size)
    max_mismatch_rate: float = 0.05             # -maxmm
    max_clip_size: int = 5                      # -maxclip
    max_duplicate: int = 5                      # -dup (1..15)
    fragment_size: int = 500                    # -size
    use_nw: bool = True                         # -alg nw|ksw2
    unique_only: bool = True                    # -m sets False (multi alignments)

    # calling parameters
    ploidy: int = 2                             # -ploidy (1 or 2)
    min_allele_depth: int = 5                   # -ad
    min_cnv_size: int = 50                      # -min_cnv
    min_unmapped_size: int = 50                 # -min_gap
    frequency_thr: float = 0.2                  # FrequencyThr
    min_read_depth: int = 20                    # (-dp; disabled in reference)
    min_var_conf_score: int = 10
    gvcf: bool = False                          # -gvcf
    obs_pos: int = -1                           # -obs (debug locus dump)
    obr_beg: int = -1                           # -obr beg end (region dump)
    obr_end: int = -1
    monomorphic: bool = False                   # -monomorphic
    somatic: bool = False                       # -somatic
    apply_filter: bool = False                  # -filter

    # output
    sam_file: Optional[str] = None              # -sam
    bam_file: Optional[str] = None              # -bam
    vcf_file: str = "output.vcf"                # -vcf
    vcf_output: bool = True                     # -no_vcf sets False
    log_file: str = "job.log"                   # -log
    sample_id: str = "unknown"                  # -id / -label

    # device execution
    backend: str = "auto"                       # auto|device|host  (host = NumPy oracle path)
    use_native: bool = True                     # C++ chunk processor (post-seeding)
    batch_size: int = 8192                      # reads per device batch
    stream_batch_size: int = 32768              # stream fast path (packed kernels)
    compact_factor: int = 0                     # seed-scan lane compaction:
                                                # lanes = batch/compact_factor;
                                                # >1 costs ~mean trajectory
                                                # instead of max. 0 = auto:
                                                # enable x4 with 131k stream
                                                # batches when the input is
                                                # large enough to fill them
                                                # (pipeline/stream.py)
    device_chain: bool = True                   # device chaining/classification
    device_evidence: bool = True                # HBM evidence planes; auto-
                                                # falls back to the host C++
                                                # diff arrays when they exceed
                                                # the device memory budget
                                                # (DeviceBackend
                                                # ._device_evidence_fits)
    index_shards: int = 0                       # >1: genome-shard the occ3
                                                # table over an N-device mesh
                                                # (human-scale index path)
    pfm_out: Optional[str] = None               # save the post-mapping PFM
    pfm_resume: Optional[str] = None            # re-run calling from a PFM
    devices: int = 1                            # data-parallel local chips
                                                # (-devices N|auto; 0 = all;
                                                # parallel/devices.py)
    big_x64: bool = False                       # force the x64 big-genome
                                                # sharded kernels (auto when
                                                # fwd+rc text >= 2^31 rows)
    fold_evidence: bool = False                 # evidence apply inside the
                                                # chain dispatch (speculative,
                                                # sparse host-reject correction)
    stream_pipeline_depth: int = 2              # device batches in flight
    stream_group: int = 4                       # batches per transfer group
                                                # (one H2D + one D2H per
                                                # group; amortizes link
                                                # latency — stream.py)
    # device NW/ksw2 kernels for the gapped-extension DP pairs instead
    # of the scalar C++ aligners (bit-identical either way)
    device_extension: bool = False
    prefix_skip_k: int = -1                     # fused seed-start skip depth
                                                # (-1 = auto by HBM slack,
                                                # 0 = off; embedded occ3 rows
                                                # make the jump gather free —
                                                # ops/fm3_device.DeviceFM3)
    max_read_len: int = 256                     # padded read length bucket

    # fixed algorithm constants (ref: structure.h:20-25, bwt_search.cpp:3-6)
    KMER_SIZE: int = 8
    MIN_SEED_LEN: int = 16
    READ_CHUNK_SIZE: int = 200
    MAX_ALLELE_COUNT: int = 4095
    OCC_THR: int = 50
    OCC_INTERVAL: int = 128
    SA_INTERVAL: int = 32

    def __post_init__(self):
        if self.max_duplicate <= 0 or self.max_duplicate > 15:
            self.max_duplicate = 15
        if self.max_pos_diff > 100:
            self.max_pos_diff = 100
        if self.ploidy > 2:
            self.ploidy = 2
        if self.gvcf and self.monomorphic:
            self.gvcf = False
