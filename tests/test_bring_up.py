"""Run-time set-up that decides where the program runs: the compile-cache
path, the native build directory, no silent host fallback, the device
memory budget and the prefix-skip policy per platform."""
import os
import subprocess

import numpy as np
import pytest

import mapcaller
from mapcaller import native
from mapcaller.config import Config
from mapcaller.index.fmindex import build_index
from mapcaller.index.packer import PackedReference
from mapcaller.pipeline import device_backend
from mapcaller.pipeline.device_backend import DeviceBackend


@pytest.fixture(scope="module")
def small_idx():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=4000).astype(np.uint8)
    return build_index(None, packed=PackedReference(["c"], [4000], [0],
                                                    codes, []))


def test_cache_dir_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert mapcaller.compilation_cache_dir() == str(tmp_path)


def test_cache_dir_default_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = mapcaller.compilation_cache_dir()
    assert path == os.path.join(mapcaller.REPO_ROOT, ".jax_cache")
    with open(os.path.join(mapcaller.REPO_ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_compilation_cache_sets_jax(monkeypatch, tmp_path):
    import jax
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert mapcaller.enable_compilation_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        monkeypatch.undo()
        mapcaller.enable_compilation_cache()


def test_native_lib_path_keyed_by_source_hash(tmp_path):
    a = tmp_path / "a.cpp"
    b = tmp_path / "b.cpp"
    a.write_text("int f() { return 1; }\n")
    b.write_text("int f() { return 2; }\n")
    pa = native.lib_path(str(a), str(tmp_path / "build"))
    assert pa == native.lib_path(str(a), str(tmp_path / "build"))
    assert pa != native.lib_path(str(b), str(tmp_path / "build"))
    assert os.path.dirname(pa) == str(tmp_path / "build")
    # the default build directory lives in the checkout and is ignored
    assert native.BUILD_DIR == os.path.join(mapcaller.REPO_ROOT,
                                            ".native_build")


def test_native_build_compiles_once_and_raises_on_error(tmp_path):
    ok = tmp_path / "ok.cpp"
    ok.write_text('extern "C" int mc_probe() { return 7; }\n')
    so = native.ensure_built(str(ok), str(tmp_path / "build"))
    assert os.path.exists(so)
    mtime = os.path.getmtime(so)
    assert native.ensure_built(str(ok), str(tmp_path / "build")) == so
    assert os.path.getmtime(so) == mtime
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(subprocess.CalledProcessError):
        native.ensure_built(str(bad), str(tmp_path / "build"))


def test_no_native_library_is_committed():
    out = subprocess.run(["git", "ls-files", "native"], capture_output=True,
                         text=True, cwd=mapcaller.REPO_ROOT)
    if out.returncode != 0:
        pytest.skip("not a git checkout")
    assert not [f for f in out.stdout.split() if f.endswith(".so")]


@pytest.mark.parametrize("backend", ["auto", "device"])
def test_make_engine_raises_on_broken_device_backend(monkeypatch, small_idx,
                                                     backend):
    from mapcaller.runner import make_engine

    def broken(*a, **k):
        raise RuntimeError("device backend unavailable")

    monkeypatch.setattr(device_backend, "DeviceBackend", broken)
    with pytest.raises(RuntimeError, match="device backend unavailable"):
        make_engine(small_idx, Config(backend=backend, vcf_output=False))


@pytest.mark.parametrize("backend", ["auto", "device"])
def test_make_engine_raises_on_broken_native(monkeypatch, small_idx,
                                             backend):
    from mapcaller.runner import make_engine

    def broken(*a, **k):
        raise OSError("libmc_native failed to load")

    monkeypatch.setattr(native, "NativeEngine", broken)
    with pytest.raises(OSError, match="libmc_native"):
        make_engine(small_idx, Config(backend=backend, vcf_output=False))


def test_make_engine_rejects_unknown_backend(small_idx):
    from mapcaller.runner import make_engine
    with pytest.raises(ValueError, match="unknown backend"):
        make_engine(small_idx, Config(backend="cuda", vcf_output=False))


def test_cli_exits_with_the_device_error(monkeypatch, tmp_path, small_idx):
    """The CLI surfaces the failure (non-zero exit), never the host path."""
    from mapcaller import cli
    prefix = str(tmp_path / "idx")
    small_idx.save(prefix)
    fq = tmp_path / "r.fq"
    fq.write_text("@r\n" + "A" * 50 + "\n+\n" + "I" * 50 + "\n")

    def broken(*a, **k):
        raise RuntimeError("no device")

    monkeypatch.setattr(device_backend, "DeviceBackend", broken)
    with pytest.raises(RuntimeError, match="no device"):
        cli.main(["mapcaller", "-i", prefix, "-f", str(fq), "-sam",
                  str(tmp_path / "o.sam"), "-no_vcf", "-log",
                  str(tmp_path / "o.log")])


class _Dev:
    def __init__(self, platform, stats):
        self.platform = platform
        self.device_kind = f"fake {platform}"
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_hbm_bytes_raises_on_accelerator_without_stats(monkeypatch):
    import jax
    monkeypatch.delenv("MC_HBM_BYTES", raising=False)
    monkeypatch.setattr(jax, "local_devices", lambda: [_Dev("gpu", None)])
    with pytest.raises(RuntimeError, match="reports no memory limit"):
        DeviceBackend._hbm_bytes()


def test_hbm_bytes_reads_the_reserved_share(monkeypatch):
    import jax
    monkeypatch.delenv("MC_HBM_BYTES", raising=False)
    monkeypatch.setattr(jax, "local_devices",
                        lambda: [_Dev("gpu", {"bytes_limit": 60 << 30})])
    assert DeviceBackend._hbm_bytes() == 60 << 30
    monkeypatch.setenv("MC_HBM_BYTES", str(8 << 30))
    assert DeviceBackend._hbm_bytes() == 8 << 30


def _policy_backend(k, shards=0, genome_mb=4.6):
    be = DeviceBackend.__new__(DeviceBackend)

    class _I:
        genome_size = int(genome_mb * 1e6)
        seq_len = 2 * int(genome_mb * 1e6)

    be.idx = _I()
    be.cfg = Config(prefix_skip_k=k)
    be.index_shards = shards
    be._fm3_ok = True
    be.device_evidence_ok = True
    return be


@pytest.mark.parametrize("platform,k,shards,want", [
    ("gpu", -1, 0, 10),    # auto: largest expected skip at 9.2e6 rows
    ("gpu", 12, 0, 12),    # explicit depth is honoured on a card
    ("gpu", -1, 4, 0),     # sharded tables embed no prefix rows
    ("cpu", -1, 0, 6),     # CPU test cap
    ("cpu", 12, 0, 8),
])
def test_prefix_skip_policy(monkeypatch, platform, k, shards, want):
    import jax
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    monkeypatch.setenv("MC_HBM_BYTES", str(60 << 30))
    assert _policy_backend(k, shards)._prefix_skip_k() == want


def test_prefix_skip_auto_respects_slack(monkeypatch):
    """With no room for even the K=8 table the auto policy turns the
    skip off instead of overflowing the budget."""
    import jax
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    be = _policy_backend(-1)
    monkeypatch.setenv("MC_HBM_BYTES", str(be.predicted_bytes(0)
                                           + 500_000_000))
    assert be._prefix_skip_k() == 0
