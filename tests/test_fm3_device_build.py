"""On-device occ3 construction (_occ3_rows_device) must be
bit-identical to the host builder (index/occ3.build_occ3) — rows,
c3_first, correction rows, and the derived scalar constants."""
import numpy as np
import pytest

from mapcaller.index.fmindex import FMIndex, build_index, pack_words
from mapcaller.index.occ3 import build_occ3
from mapcaller.index.packer import PackedReference
from mapcaller.ops.fm3_device import DeviceFM3, _occ3_rows_device


def _idx_from_codes(codes):
    ref = PackedReference(["c1"], [len(codes)], [0], codes, [])
    return build_index(None, packed=ref)


@pytest.mark.parametrize("L", [503, 1000, 4093, 8192, 20011])
def test_device_rows_match_host(rng, L):
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    idx = _idx_from_codes(codes)
    text = idx.ref.fwd_rc_codes()
    host = build_occ3(idx.sa_full, text)

    import jax.numpy as jnp
    n = idx.seq_len
    nw3 = (n + 16) // 16 + 2
    w = pack_words(text)
    words = jnp.asarray(np.concatenate([w, np.zeros(2, dtype=np.uint32)]))
    rows, c3, pp = _occ3_rows_device(jnp.asarray(idx.sa_full), words, n, nw3)
    assert np.array_equal(np.asarray(rows), np.asarray(host.rows))
    assert np.array_equal(np.asarray(c3), np.asarray(host.c3_first))
    assert (int(pp[0]), int(pp[1])) == (host.row_p1, host.row_p2)


def test_from_host_device_build_scalars(rng):
    codes = rng.integers(0, 4, size=6007).astype(np.uint8)
    idx = _idx_from_codes(codes)
    host = build_occ3(idx.sa_full, idx.ref.fwd_rc_codes())
    fm3 = DeviceFM3.from_host(idx)   # takes the device-build path
    assert (fm3.row_p1, fm3.row_p2) == (host.row_p1, host.row_p2)
    assert (fm3.t0, fm3.t1) == (host.t0, host.t1)
    assert (fm3.tail1, fm3.tail2a, fm3.tail2b) == (
        host.tail1, host.tail2a, host.tail2b)
    assert np.array_equal(np.asarray(fm3.occ3_rows), np.asarray(host.rows))
    assert np.array_equal(np.asarray(fm3.c3_first),
                          np.asarray(host.c3_first))


def test_toy_genome_device_build(toy_fasta):
    idx = build_index(toy_fasta)
    host = build_occ3(idx.sa_full, idx.ref.fwd_rc_codes())
    fm3 = DeviceFM3.from_host(idx)
    assert np.array_equal(np.asarray(fm3.occ3_rows), np.asarray(host.rows))
    assert np.array_equal(np.asarray(fm3.c3_first),
                          np.asarray(host.c3_first))
    assert (fm3.row_p1, fm3.row_p2, fm3.t0, fm3.t1, fm3.tail1, fm3.tail2a,
            fm3.tail2b) == (host.row_p1, host.row_p2, host.t0, host.t1,
                            host.tail1, host.tail2a, host.tail2b)
