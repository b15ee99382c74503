"""Segment-level succinct codec: frame-of-reference + vertical bit-packing.

Parity with the reference's segment compaction machinery
(src/storage/table/column_segment.cpp:273-520 BitCompressFromUncompressed /
UncompressSuccinct): compute min/max over the segment, subtract the minimum
("extract prefix"), pack codes at width hi(max-min)+1 (optionally padded to
the next byte), and decode by adding the minimum back. Differences, by
design:

- the bit layout is the vertical lane layout of ops/bitpack.py (vectorized
  decode, no serial bit cursor);
- 64-bit logical types are split into lo/hi 32-bit planes packed
  independently — the hi plane of clustered data packs to width 0, i.e. a
  *constant plane* that stores nothing (this subsumes the reference's
  numeric_constant codec, src/storage/compression/numeric_constant.cpp);
- encode/decode are jitted device kernels; only min/max extraction syncs to
  host (two scalars), once, at pack time.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from adacom.ops import bitpack
from adacom import types as tt

_U32 = jnp.uint32


@dataclasses.dataclass
class PackedData:
    """Device-resident packed representation of one segment's values."""

    # Per plane: words array (width, L) uint32, or None when width == 0
    # (constant plane). Plane 0 = low 32 bits, plane 1 = high 32 bits.
    words: Tuple[Optional[jax.Array], ...]
    widths: Tuple[int, ...]
    # frame-of-reference minimum (python int, in the logical domain)
    min_factor: int
    count: int
    n_lanes: int
    dtype: np.dtype  # logical storage dtype
    # lazily-built device scalar of min_factor: building it per read costs
    # a tiny H2D transfer per segment on every full-table scan
    _mf_dev: Optional[jax.Array] = dataclasses.field(
        default=None, compare=False, repr=False)

    def mf_dev(self) -> jax.Array:
        if self._mf_dev is None:
            self._mf_dev = jnp.asarray(self.min_factor, dtype=self.dtype)
        return self._mf_dev

    @property
    def nbytes(self) -> int:
        return sum(0 if w is None else w.size * 4 for w in self.words)

    @property
    def meta(self) -> tuple:
        """Static trace key: everything that changes the compiled kernel."""
        return (self.widths, self.n_lanes, str(self.dtype))


def plan_widths(
    vmin: int,
    vmax: int,
    itemsize: int,
    *,
    extract_prefix: bool = True,
    padded_to_byte: bool = False,
) -> tuple[tuple[int, ...], int]:
    """Compute (plane widths, min_factor) from segment stats alone — the
    same decision pack_segment makes, usable without touching the data
    (e.g. to account the footprint of a paged-out compacted segment)."""
    min_factor = vmin if extract_prefix else (0 if vmin >= 0 else vmin)
    span = vmax - min_factor
    if itemsize == 8:
        lo_w = 32 if span >= (1 << 32) else (0 if span == 0 else bitpack.width_for_span(span, padded_to_byte))
        hi_span = span >> 32
        hi_w = 0 if hi_span == 0 else bitpack.width_for_span(hi_span, padded_to_byte)
        return (lo_w, hi_w), min_factor
    return ((0 if span == 0 else bitpack.width_for_span(span, padded_to_byte)),), min_factor


def packed_nbytes(widths: tuple, n_lanes: int) -> int:
    return sum(w * n_lanes * 4 for w in widths)


def _split_planes(codes: jax.Array, two_planes: bool):
    """codes: unsigned 64- or 32-bit device array of (v - min)."""
    if not two_planes:
        return [codes.astype(_U32)]
    lo = (codes & jnp.uint64(0xFFFFFFFF)).astype(_U32)
    hi = (codes >> jnp.uint64(32)).astype(_U32)
    return [lo, hi]


@functools.partial(jax.jit, static_argnames=("signed",))
def _minmax(values: jax.Array, *, signed: bool):
    return jnp.min(values), jnp.max(values)


def compute_span(values: jax.Array, ltype: tt.LogicalType) -> tuple[int, int]:
    """Return (min, max) as python ints (one host sync)."""
    mn, mx = _minmax(values, signed=ltype.signed)
    return int(mn), int(mx)


def pack_segment(
    values: jax.Array,
    ltype: tt.LogicalType,
    *,
    extract_prefix: bool = True,
    padded_to_byte: bool = False,
    vmin: Optional[int] = None,
    vmax: Optional[int] = None,
) -> PackedData:
    """Encode a device value array into PackedData.

    values: device array in the segment's compute dtype (i32/u32/i64/u64).
    vmin/vmax: pre-computed stats (zonemap) to avoid a second reduction.
    """
    count = values.shape[0]
    n_lanes = bitpack.lanes_for(count)
    if vmin is None or vmax is None:
        vmin, vmax = compute_span(values, ltype)
    widths, min_factor = plan_widths(
        vmin, vmax, values.dtype.itemsize,
        extract_prefix=extract_prefix, padded_to_byte=padded_to_byte,
    )
    words = _pack_kernel(
        values,
        jnp.asarray(min_factor, dtype=values.dtype),
        widths=tuple(widths),
        n_lanes=n_lanes,
    )
    return PackedData(
        words=words,
        widths=tuple(widths),
        min_factor=min_factor,
        count=count,
        n_lanes=n_lanes,
        dtype=np.dtype(values.dtype),
    )


@functools.partial(jax.jit, static_argnames=("widths", "n_lanes"))
def _pack_kernel(values, min_factor, *, widths, n_lanes):
    is64 = values.dtype.itemsize == 8
    udt = jnp.uint64 if is64 else _U32
    codes = (values - min_factor).astype(udt) if values.dtype != udt else values - min_factor.astype(udt)
    planes = _split_planes(codes, is64)
    out = []
    for plane, w in zip(planes, widths):
        if w == 0:
            out.append(None)
        else:
            out.append(bitpack.pack(bitpack.pad_codes(plane, n_lanes), width=w))
    return tuple(out)


def decode_traced(
    words: Tuple[Optional[jax.Array], ...],
    min_factor: jax.Array,
    *,
    widths: Tuple[int, ...],
    compute_dtype,
) -> jax.Array:
    """Traceable decode: padded flat array in compute dtype.

    Usable inside a larger jit (fused with filters/aggregates). `min_factor`
    is a dynamic scalar so per-segment minima don't trigger recompiles.
    """
    is64 = len(widths) == 2
    if is64:
        lo_w, hi_w = widths
        if lo_w == 0:
            lo = None
        else:
            lo = bitpack.unpack(words[0], width=lo_w).reshape(-1)
        if hi_w == 0:
            hi = None
        else:
            hi = bitpack.unpack(words[1], width=hi_w).reshape(-1)
        if lo is None and hi is None:
            raise ValueError("use decode_constant for fully-constant segments")
        base = lo if lo is not None else jnp.zeros_like(hi)
        v = base.astype(jnp.uint64)
        if hi is not None:
            v = v | (hi.astype(jnp.uint64) << jnp.uint64(32))
        return v.astype(compute_dtype) + min_factor.astype(compute_dtype)
    (w,) = widths
    if w == 0:
        raise ValueError("use decode_constant for fully-constant segments")
    codes = bitpack.unpack(words[0], width=w).reshape(-1)
    return codes.astype(compute_dtype) + min_factor.astype(compute_dtype)


def decode_constant(min_factor: jax.Array, n: int, compute_dtype) -> jax.Array:
    return jnp.full((n,), min_factor, dtype=compute_dtype)


@functools.partial(jax.jit, static_argnames=("widths", "n", "compute_dtype"))
def _decode_jit(words, min_factor, *, widths, n, compute_dtype):
    if all(w == 0 for w in widths):
        return decode_constant(min_factor, n, compute_dtype)
    out = decode_traced(words, min_factor, widths=widths, compute_dtype=compute_dtype)
    return out[:n] if out.shape[0] != n else out


def unpack_segment(packed: PackedData, compute_dtype=None) -> jax.Array:
    """Standalone decode of a whole segment -> device array of count values."""
    if compute_dtype is None:
        compute_dtype = packed.dtype
    n_pad = bitpack.ROWS * packed.n_lanes
    mf = jnp.asarray(packed.min_factor, dtype=packed.dtype)
    if all(w == 0 for w in packed.widths):
        return _decode_jit((), mf, widths=packed.widths, n=packed.count,
                           compute_dtype=jnp.dtype(compute_dtype))
    return _decode_jit(tuple(packed.words), mf, widths=packed.widths,
                       n=packed.count, compute_dtype=jnp.dtype(compute_dtype))


def gather_segment(packed: PackedData, idx: jax.Array) -> jax.Array:
    """Random-access decode of rows `idx` (FetchRow parity, touches only the
    words containing those rows — fixes succinct.cpp:250-259's full decode)."""
    mf = jnp.asarray(packed.min_factor, dtype=packed.dtype)
    is64 = len(packed.widths) == 2
    if is64:
        lo_w, hi_w = packed.widths
        lo = (bitpack.gather_codes(packed.words[0], idx, width=lo_w, n_lanes=packed.n_lanes)
              if lo_w else jnp.zeros(idx.shape, _U32))
        hi = (bitpack.gather_codes(packed.words[1], idx, width=hi_w, n_lanes=packed.n_lanes)
              if hi_w else jnp.zeros(idx.shape, _U32))
        v = lo.astype(jnp.uint64) | (hi.astype(jnp.uint64) << jnp.uint64(32))
        return v.astype(packed.dtype) + mf
    (w,) = packed.widths
    if w == 0:
        return jnp.full(idx.shape, mf, dtype=packed.dtype)
    codes = bitpack.gather_codes(packed.words[0], idx, width=w, n_lanes=packed.n_lanes)
    return codes.astype(packed.dtype) + mf
