"""MapCaller-JAX: a short-read mapper + variant caller on JAX accelerators.

A from-scratch JAX/XLA re-design of the capabilities of
hsinnan75/MapCaller: BWT/FM-index seeding, seed chaining, gapped
extension, on-device evidence accumulation (position-frequency matrix +
indel/breakpoint event tables) and a single-pass variant caller emitting
VCF.

Layer map (mirrors SURVEY.md section 1):
  index/    — offline index construction + load     (ref: src/BWT_Index, bwt_index.cpp)
  io/       — FASTQ/FASTA input, SAM/VCF output     (ref: src/GetData.cpp, SamReport.cpp)
  ops/      — device kernels: FM-search, banded DP,
              PFM scatter-add                       (ref: src/bwt_search.cpp, nw_alignment.cpp,
                                                     ksw2_alignment.cpp, AlignmentProfile.cpp)
  pipeline/ — mapping engine: chaining, pairing,
              rescue, alignment production          (ref: src/ReadMapping.cpp, ReadAlignment.cpp,
                                                     AlignmentRescue.cpp, KmerAnalysis.cpp)
  calling/  — variant caller + SV detection         (ref: src/VariantCalling.cpp)
  parallel/ — device mesh, sharded PFM reduction    (reference is pthreads-only)
"""
import os

__version__ = "0.1.0"

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tune_host_allocator() -> None:
    """Keep large numpy temporaries on the reusable glibc heap instead of
    fresh mmaps: first-touch page faults cost far more than the compute
    of a genome-sized array pass."""
    import ctypes
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:          # not glibc: keep the default allocator
        return
    libc.mallopt(-3, 1 << 30)   # M_MMAP_THRESHOLD
    libc.mallopt(-1, 1 << 30)   # M_TRIM_THRESHOLD


def compilation_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else the fixed, git-ignored
    `.jax_cache/` in the checkout (a fixed path: the directory is part of
    the cache key, so a moving one never hits)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(REPO_ROOT, ".jax_cache"))


def enable_compilation_cache() -> str:
    """Persistent XLA compilation cache: the seed kernels take tens of
    seconds to compile; cached reloads take seconds. Returns the path."""
    import jax
    path = compilation_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
