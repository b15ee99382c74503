"""Native C++ runtime vs NumPy/JAX goldens."""

import numpy as np
import pytest

from adacom import native
from adacom.ops import bitpack


needs_native = pytest.mark.skipif(not native.available(), reason="no native lib")


@needs_native
@pytest.mark.parametrize("width", [1, 7, 16, 17, 31, 32])
def test_native_pack_matches_layout(width, rng):
    n = 10_000
    codes = (rng.integers(0, 1 << 32, n, dtype=np.uint64) &
             ((1 << width) - 1)).astype(np.uint32)
    got = native.pack_u32(codes, width)
    exp = bitpack.pack_numpy(codes, width)
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(native.unpack_u32(got, n, width), codes)


@needs_native
def test_native_gather(rng):
    n, width = 5000, 19
    codes = rng.integers(0, 1 << width, n, dtype=np.uint32)
    words = native.pack_u32(codes, width)
    L = bitpack.lanes_for(n)
    idx = rng.integers(0, n, 200)
    np.testing.assert_array_equal(
        native.gather_u32(words, L, width, idx), codes[idx]
    )


@needs_native
def test_native_filters(rng):
    vals = rng.integers(0, 100, 10_000).astype(np.uint32)
    v = 42
    np.testing.assert_array_equal(
        native.filter_eq_u32(vals, v), np.nonzero(vals == v)[0]
    )


@needs_native
def test_native_packed_filter_eq(rng):
    n, width = 20_000, 17
    base = 1_000_000
    vals = (base + rng.integers(0, 1 << width, n)).astype(np.uint64)
    codes = (vals - base).astype(np.uint32)
    words = native.pack_u32(codes, width)
    v = int(vals[1234])
    got = native.packed_filter_eq_u32(words, n, width, base, v)
    np.testing.assert_array_equal(got, np.nonzero(vals == v)[0])
    # miss below min_factor and above span
    assert len(native.packed_filter_eq_u32(words, n, width, base, 5)) == 0


@needs_native
def test_native_zipf():
    s = native.zipf_sample(10_000, 1.0, 7, 20_000)
    assert s.min() >= 1 and s.max() <= 10_000
    vals, counts = np.unique(s, return_counts=True)
    assert vals[np.argmax(counts)] <= 3


def test_groupby_i64_matches_unique():
    import numpy as np
    from adacom import native

    keys = np.random.default_rng(3).integers(-50, 50, 100_000).astype(np.int64)
    gid, first = native.groupby_i64(keys)
    assert len(first) == len(np.unique(keys))
    # every row's gid maps back to its own key
    uniq_vals = keys[first]
    assert (uniq_vals[gid] == keys).all()
    # first-occurrence order
    assert (np.sort(first) == first).all()


def test_group_sum_exact():
    import numpy as np
    from adacom import native

    gid = np.random.default_rng(4).integers(0, 7, 50_000).astype(np.int64)
    vals = np.random.default_rng(5).integers(-2**40, 2**40, 50_000)
    out = native.group_sum(gid, vals, 7)
    exp = np.asarray([vals[gid == g].sum() for g in range(7)])
    assert (out == exp).all()


def test_argsort_u64_radix():
    import numpy as np
    from adacom import native

    keys = np.random.default_rng(6).integers(0, 2**63, 200_000).astype(np.uint64)
    idx = native.argsort_u64(keys)
    assert (np.diff(keys[idx].astype(np.int64)) >= 0).all()
    # stability: equal keys keep row order
    keys2 = (np.arange(100_000) % 17).astype(np.uint64)
    idx2 = native.argsort_u64(keys2)
    for g in (0, 5, 16):
        rows = idx2[keys2[idx2] == g]
        assert (np.diff(rows) > 0).all()
