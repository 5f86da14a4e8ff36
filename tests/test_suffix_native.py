"""Native SA-IS vs the NumPy prefix-doubling oracle."""
import numpy as np
import pytest

from mapcaller.index.suffix import (_build_suffix_array_native,
                                        _build_suffix_array_numpy)


@pytest.mark.parametrize("n", [2, 3, 17, 256, 4097, 100_000])
def test_native_sa_matches_oracle(n, rng):
    t = rng.integers(0, 4, size=n).astype(np.uint8)
    assert np.array_equal(_build_suffix_array_native(t),
                          _build_suffix_array_numpy(t))


def test_lean_builder_matches_core_oracle(rng):
    """The lean in-SA-workspace SA-IS (mc_build_sa_full*, used by
    build_index) against the retained sais_core oracle entry — SA is
    unique, so equality is a complete correctness test. Exercises the
    int32/int64 entries and the i32-downcast recursion branch."""
    import ctypes as C

    from mapcaller.native import _ptr, load_lib
    lib = load_lib()
    lib.mc_build_sa_full_oracle.argtypes = [C.c_void_p, C.c_int64,
                                            C.c_void_p]
    lib.mc_build_sa_full.argtypes = [C.c_void_p, C.c_int64, C.c_void_p]
    lib.mc_build_sa_full64.argtypes = [C.c_void_p, C.c_int64, C.c_void_p]
    for trial in range(40):
        n = int(rng.integers(1, 4000))
        t = rng.integers(0, 4, size=n).astype(np.uint8)
        if trial % 3 == 0:   # low-entropy: runs -> deep LMS recursion
            t = np.repeat(rng.integers(0, 3, size=max(1, n // 6))
                          .astype(np.uint8), 7)[:n]
        lean = np.empty(n + 1, np.int32)
        lib.mc_build_sa_full(_ptr(t), n, _ptr(lean))
        core = np.empty(n + 1, np.int32)
        lib.mc_build_sa_full_oracle(_ptr(t), n, _ptr(core))
        assert np.array_equal(lean, core), trial
        lean64 = np.empty(n + 1, np.int64)
        lib.mc_build_sa_full64(_ptr(t), n, _ptr(lean64))
        assert np.array_equal(lean64.astype(np.int32), core), trial


def test_native_sa_repetitive(rng):
    # repetitive text stresses the LMS-naming recursion
    unit = rng.integers(0, 4, size=7).astype(np.uint8)
    t = np.tile(unit, 2000)
    assert np.array_equal(_build_suffix_array_native(t),
                          _build_suffix_array_numpy(t))
    t2 = np.zeros(5000, dtype=np.uint8)  # single-symbol text
    assert np.array_equal(_build_suffix_array_native(t2),
                          _build_suffix_array_numpy(t2))
