"""Codec goldens: JAX vertical bit-packing vs the NumPy reference encoder.

The reference fork has NO codec correctness tests (SURVEY.md §4); these are
the tests it should have had, for our layout.
"""

import numpy as np
import pytest

from adacom.ops import bitpack


def _roundtrip(codes: np.ndarray, width: int):
    n = codes.shape[0]
    L = bitpack.lanes_for(n)
    rows = bitpack.pad_codes(codes, L)
    words = bitpack.pack(rows, width=width)
    out = bitpack.unpack_flat(words, n, width=width)
    return np.asarray(words), np.asarray(out)


@pytest.mark.parametrize("width", [1, 2, 3, 5, 7, 8, 11, 13, 16, 17, 20, 24, 31, 32])
def test_roundtrip_random(width, rng):
    n = 10_000
    hi = (1 << width) - 1
    codes = rng.integers(0, hi + 1 if hi < 2**63 else hi, size=n, dtype=np.uint64)
    codes = (codes & hi).astype(np.uint32)
    words, out = _roundtrip(codes, width)
    np.testing.assert_array_equal(out, codes)
    # layout identical to the NumPy golden encoder
    np.testing.assert_array_equal(words, bitpack.pack_numpy(codes, width))
    np.testing.assert_array_equal(bitpack.unpack_numpy(words, n, width), codes)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 63, 64, 1000, 4096])
def test_roundtrip_sizes(n, rng):
    width = 17
    codes = rng.integers(0, 1 << width, size=n, dtype=np.uint32)
    _, out = _roundtrip(codes, width)
    np.testing.assert_array_equal(out, codes)


def test_footprint_matches_reference_bit_count():
    # N*w bits, like sdsl::int_vector<>(N, 0, w)
    n, width = 100_000, 13
    L = bitpack.lanes_for(n)
    words = bitpack.pack(bitpack.pad_codes(np.zeros(n, np.uint32), L), width=width)
    padded_n = bitpack.ROWS * L
    assert words.size * 32 == padded_n * width


def test_gather_codes_random_access(rng):
    n, width = 5_000, 19
    codes = rng.integers(0, 1 << width, size=n, dtype=np.uint32)
    L = bitpack.lanes_for(n)
    words = bitpack.pack(bitpack.pad_codes(codes, L), width=width)
    idx = rng.integers(0, n, size=257)
    got = bitpack.gather_codes(words, np.asarray(idx), width=width, n_lanes=L)
    np.testing.assert_array_equal(np.asarray(got), codes[idx])


def test_width_for_span():
    assert bitpack.width_for_span(0) == 1
    assert bitpack.width_for_span(1) == 1
    assert bitpack.width_for_span(2) == 2
    assert bitpack.width_for_span(255) == 8
    assert bitpack.width_for_span(256) == 9
    assert bitpack.width_for_span(256, padded_to_byte=True) == 16
    assert bitpack.width_for_span(2**32 - 1) == 32


def test_width1_is_validity_bitmap(rng):
    # width-1 packing doubles as the validity-mask codec
    n = 3000
    bits = rng.integers(0, 2, size=n, dtype=np.uint32)
    _, out = _roundtrip(bits, 1)
    np.testing.assert_array_equal(out, bits)
