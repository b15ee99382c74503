"""Frame-of-reference bit-packing codec in a *vertical lane* layout.

Capability parity with the reference succinct codec
(src/storage/compression/succinct.cpp + sdsl::int_vector<>): store N integer
codes at a fixed bit width w in a dense bit array of N*w bits, decode adds
back a per-segment minimum ("extract prefix", config.hpp:190). The reference
packs codes *serially* (sdsl bits::write_int_and_move), which decodes one
element at a time; that layout is hostile to a vector unit.

Here the layout is re-designed for vector hardware: values are split into groups
of 32 consecutive elements laid out across *lanes*:

    element i  ->  row r = i // L, lane = i % L      (L = ceil(N/32) lanes)

i.e. the padded value array reshaped to (32, L). Packing walks the 32 rows
once, accumulating shifted codes into one uint32 accumulator *per lane*, and
emits exactly w words per lane -> a dense (w, L) uint32 array = N*w bits, the
same footprint as the reference's sdsl bit vector. Because the row loop is a
static Python loop over elementwise jnp ops, XLA compiles encode and decode
into a handful of fused vector loops: decode streams w words/32 values and
writes 32 values with shifts/masks only — HBM-bandwidth bound, no gathers.

Random access (FetchRow parity, succinct.cpp:244-260) needs only the 1-2
words that hold element i's bits — unlike the reference, which decodes the
whole segment per row fetch (a known defect, see SURVEY.md §2.1).

Widths 1..32 are supported; 64-bit logical types are stored by the segment
layer as two 32-bit planes packed independently (hi plane of
small/sequential data packs to ~0 bits).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

ROWS = 32  # elements per packing group == bits per packed word

_U32 = jnp.uint32


def lanes_for(n: int) -> int:
    """Number of lanes (packing groups) for n elements."""
    return max(1, (n + ROWS - 1) // ROWS)


def width_for_span(span: int, padded_to_byte: bool = False) -> int:
    """Minimal bit width for codes in [0, span] (sdsl bits::hi(max)+1 parity,
    column_segment.cpp:385; byte padding per config
    succinct_padded_to_next_byte_enabled)."""
    if span < 0:
        raise ValueError("span must be >= 0")
    w = max(1, int(span).bit_length())
    if padded_to_byte:
        w = min(32, (w + 7) & ~7)
    return min(w, 32)


def pad_codes(codes: np.ndarray | jax.Array, n_lanes: int) -> jax.Array:
    """Pad a flat uint32 code array to ROWS*n_lanes and reshape to (ROWS, L)."""
    n = codes.shape[0]
    total = ROWS * n_lanes
    codes = jnp.asarray(codes, dtype=_U32)
    if n < total:
        codes = jnp.pad(codes, (0, total - n))
    return codes.reshape(ROWS, n_lanes)


@functools.partial(jax.jit, static_argnames=("width",))
def pack(rows: jax.Array, *, width: int) -> jax.Array:
    """Pack (ROWS, L) uint32 codes at `width` bits -> (width, L) uint32 words.

    Vertical layout: word k of lane l holds bits [32k, 32k+32) of the
    concatenated 32 codes of that lane.
    """
    if not (1 <= width <= 32):
        raise ValueError(f"width must be in 1..32, got {width}")
    L = rows.shape[1]
    mask = _U32((1 << width) - 1) if width < 32 else _U32(0xFFFFFFFF)
    words = []
    acc = jnp.zeros((L,), dtype=_U32)
    shift = 0
    for r in range(ROWS):
        val = rows[r] & mask
        acc = acc | (val << _U32(shift)) if shift < 32 else acc
        shift += width
        if shift >= 32:
            words.append(acc)
            rem = shift - 32
            acc = (val >> _U32(width - rem)) if rem > 0 else jnp.zeros((L,), _U32)
            shift = rem
    assert shift == 0 and len(words) == width
    return jnp.stack(words)


@functools.partial(jax.jit, static_argnames=("width",))
def unpack(words: jax.Array, *, width: int) -> jax.Array:
    """Unpack (width, L) uint32 words -> (ROWS, L) uint32 codes."""
    if not (1 <= width <= 32):
        raise ValueError(f"width must be in 1..32, got {width}")
    mask = _U32((1 << width) - 1) if width < 32 else _U32(0xFFFFFFFF)
    out = []
    for r in range(ROWS):
        p = r * width
        k, off = p >> 5, p & 31
        code = words[k] >> _U32(off) if off else words[k]
        if off + width > 32:
            code = code | (words[k + 1] << _U32(32 - off))
        out.append(code & mask)
    return jnp.stack(out)


def unpack_flat(words: jax.Array, count: int, *, width: int) -> jax.Array:
    """Unpack to a flat uint32 array of `count` codes (drops lane padding)."""
    return unpack(words, width=width).reshape(-1)[:count]


@functools.partial(jax.jit, static_argnames=("width", "n_lanes"))
def gather_codes(words: jax.Array, idx: jax.Array, *, width: int, n_lanes: int) -> jax.Array:
    """Random-access decode: codes at flat positions `idx` (any shape).

    Touches only the <=2 words containing each element's bits — the
    fix for the reference's whole-segment FetchRow decode
    (succinct.cpp:250-259).
    """
    idx = idx.astype(jnp.int32)
    r = idx // n_lanes
    lane = idx % n_lanes
    p = r * width
    k, off = p >> 5, (p & 31).astype(_U32)
    mask = _U32((1 << width) - 1) if width < 32 else _U32(0xFFFFFFFF)
    w0 = words[k, lane]
    code = w0 >> off
    if width > 1:
        # straddle word (only read when needed; clamp index for safety)
        k1 = jnp.minimum(k + 1, words.shape[0] - 1)
        w1 = words[k1, lane]
        straddle = (off.astype(jnp.int32) + width) > 32
        ext_shift = (_U32(32) - off) & _U32(31)
        code = jnp.where(straddle, code | (w1 << ext_shift), code)
    return code & mask


# ---------------------------------------------------------------------------
# NumPy golden reference (host-side; used by tests and the native C++ codec
# as the single source of truth for the bit layout).
# ---------------------------------------------------------------------------


def pack_numpy(codes: np.ndarray, width: int) -> np.ndarray:
    """Reference encoder: identical layout, plain NumPy (uint64 staging)."""
    n = codes.shape[0]
    L = lanes_for(n)
    rows = np.zeros((ROWS, L), dtype=np.uint64)
    padded = np.zeros(ROWS * L, dtype=np.uint64)
    padded[:n] = codes.astype(np.uint64) & ((1 << width) - 1)
    rows[:] = padded.reshape(ROWS, L)
    words = np.zeros((width, L), dtype=np.uint32)
    acc = np.zeros(L, dtype=np.uint64)
    shift = 0
    k = 0
    for r in range(ROWS):
        acc |= rows[r] << np.uint64(shift)
        shift += width
        if shift >= 32:
            words[k] = (acc & 0xFFFFFFFF).astype(np.uint32)
            acc >>= np.uint64(32)
            shift -= 32
            k += 1
    assert shift == 0 and k == width
    return words


def unpack_numpy(words: np.ndarray, count: int, width: int) -> np.ndarray:
    L = words.shape[1]
    mask = np.uint64((1 << width) - 1)
    out = np.zeros((ROWS, L), dtype=np.uint64)
    for r in range(ROWS):
        p = r * width
        k, off = p >> 5, p & 31
        code = words[k].astype(np.uint64) >> np.uint64(off)
        if off + width > 32:
            code |= words[k + 1].astype(np.uint64) << np.uint64(32 - off)
        out[r] = code & mask
    return out.reshape(-1)[:count].astype(np.uint32)
