"""Compression framework: codec registry + analyze-based selection.

Parity with the reference's CompressionFunction vtable and registry
(src/include/duckdb/function/compression_function.hpp:74-160,
src/function/compression_config.cpp:14-24) and the checkpoint-time
best-codec selection (ColumnDataCheckpointer::DetectBestCompressionMethod,
src/storage/checkpoint/column_data_checkpointer.cpp:86). The reference's
codec set (src/storage/compression/: bitpacking, rle, dictionary, chimp,
patas, numeric_constant, fsst, *_uncompressed) maps to device codecs:

- ``succinct``     — FOR + vertical bit-packing (ops/segcodec.py); covers the
                     reference's succinct.cpp AND bitpacking.cpp FOR mode.
- ``constant``     — all-equal segments store one scalar
                     (numeric_constant.cpp parity).
- ``rle``          — run values + run end positions; decode is a vectorized
                     searchsorted + gather (rle.cpp parity, redesigned: the
                     reference walks runs serially per scan).
- ``delta``        — zig-zag deltas in element order, FOR bit-packed, decoded
                     with a vectorized prefix-sum (bitpacking.cpp
                     DELTA_FOR mode parity); sequential keys pack to ~2 bits.
- ``dictionary``   — distinct-value LUT + bit-packed codes
                     (dictionary_compression.cpp parity; strings are
                     dictionary-encoded at ingest already, so this codec
                     serves low-cardinality *integer* segments).
- ``alp``          — exact decimal-scaled floats: f64/f32 that round-trip
                     through ``round(v * 10^e) / 10^e`` are stored as FOR
                     bit-packed integers (chimp/patas capability for the
                     float columns the benchmarks use, via the ALP scheme,
                     which vectorizes; XOR-chained chimp decode is
                     inherently serial).
- ``uncompressed`` — plain device array (fixed_size_uncompressed.cpp).

Every codec encodes host-side numpy values (encode happens at seal/compact
or checkpoint time) into device arrays plus a hashable ``meta`` trace key,
and exposes a *traceable* decoder ``decode(args) -> padded flat array`` of
ROWS*n_lanes elements so the executor can fuse decode into filter/aggregate
kernels exactly like the succinct path. Random access (FetchRow parity) is
``gather(enc, idx)``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from adacom.ops import bitpack, segcodec

ROWS = bitpack.ROWS


@dataclasses.dataclass
class Encoded:
    """Device-resident encoded segment (generic codecs)."""

    codec: str
    meta: tuple  # hashable static trace key; meta[0] == codec name
    arrays: Tuple[jax.Array, ...]  # dynamic decoder args (device)
    count: int
    nbytes: int  # logical packed footprint in bytes


def _pow2_at_least(n: int, lo: int = 8) -> int:
    p = lo
    while p < n:
        p <<= 1
    return p


def _n_pad(count: int) -> int:
    return ROWS * bitpack.lanes_for(count)


def _uint_view(values: np.ndarray) -> np.ndarray:
    """Reinterpret signed ints as unsigned of the same width (wrap-around
    delta arithmetic stays exact mod 2^w)."""
    if values.dtype.kind == "i":
        return values.view(np.dtype(f"u{values.dtype.itemsize}"))
    return values


# ======================================================================
# codec implementations
# ======================================================================


class ConstantCodec:
    """All-equal segment -> one scalar (numeric_constant.cpp parity)."""

    name = "constant"

    def analyze(self, values: np.ndarray, ltype, cfg) -> Optional[int]:
        if values.size == 0:
            return None
        if values.dtype.kind == "f":
            same = np.all(values.view(f"u{values.dtype.itemsize}") ==
                          values.view(f"u{values.dtype.itemsize}")[0])
        else:
            same = np.all(values == values[0])
        return int(values.dtype.itemsize) if same else None

    def encode(self, values: np.ndarray, ltype, cfg) -> Encoded:
        n = values.shape[0]
        v = jnp.asarray(values[0])
        meta = (self.name, _n_pad(n), str(values.dtype))
        return Encoded(self.name, meta, (v,), n, int(values.dtype.itemsize))

    def arg_count(self, meta) -> int:
        return 1

    def make_decoder(self, meta, compute_dtype):
        _, n_pad, _ = meta

        def decode(args):
            return jnp.full((n_pad,), args[0].astype(compute_dtype))

        return decode

    def gather(self, enc: Encoded, idx: jax.Array) -> jax.Array:
        return jnp.full(idx.shape, enc.arrays[0])


class RleCodec:
    """Run-length runs + end positions; decode = searchsorted + gather.

    The reference's rle.cpp scans runs with a serial cursor; here decode is
    one vectorized ``searchsorted(run_ends, iota)`` over the whole segment.
    Run count is padded to a power of two to bound kernel recompiles.
    """

    name = "rle"

    def _runs(self, values: np.ndarray):
        v = _uint_view(values) if values.dtype.kind in "iu" else values.view(
            f"u{values.dtype.itemsize}")
        change = np.empty(v.shape[0], dtype=bool)
        change[0] = True
        np.not_equal(v[1:], v[:-1], out=change[1:])
        starts = np.flatnonzero(change)
        return starts

    def analyze(self, values: np.ndarray, ltype, cfg) -> Optional[int]:
        if values.size == 0:
            return None
        starts = self._runs(values)
        r = _pow2_at_least(len(starts))
        if r >= values.size // 2:  # not run-friendly
            return None
        return r * (values.dtype.itemsize + 4)

    def encode(self, values: np.ndarray, ltype, cfg) -> Encoded:
        n = values.shape[0]
        starts = self._runs(values)
        run_values = values[starts]
        run_ends = np.empty(len(starts), dtype=np.int32)
        run_ends[:-1] = starts[1:]
        run_ends[-1] = n
        r_pad = _pow2_at_least(len(starts))
        rv = np.concatenate([run_values,
                             np.full(r_pad - len(starts), run_values[-1],
                                     dtype=values.dtype)])
        re_ = np.concatenate([run_ends,
                              np.full(r_pad - len(starts), np.int32(n),
                                      dtype=np.int32)])
        nbytes = r_pad * (values.dtype.itemsize + 4)
        meta = (self.name, r_pad, _n_pad(n), str(values.dtype))
        return Encoded(self.name, meta,
                       (jnp.asarray(rv), jnp.asarray(re_)), n, nbytes)

    def arg_count(self, meta) -> int:
        return 2

    def make_decoder(self, meta, compute_dtype):
        _, r_pad, n_pad, _ = meta

        def decode(args):
            rv, re_ = args
            pos = jnp.arange(n_pad, dtype=jnp.int32)
            run = jnp.searchsorted(re_, pos, side="right")
            run = jnp.minimum(run, r_pad - 1)
            return rv[run].astype(compute_dtype)

        return decode

    def gather(self, enc: Encoded, idx: jax.Array) -> jax.Array:
        rv, re_ = enc.arrays
        run = jnp.searchsorted(re_, idx.astype(jnp.int32), side="right")
        run = jnp.minimum(run, rv.shape[0] - 1)
        return rv[run]


class DeltaCodec:
    """Zig-zag delta + FOR bit-pack; decode via vectorized prefix sum.

    Element order is the flat (ROWS, L) row-major order of ops/bitpack.py, so
    the decode prefix-sum is a within-row cumsum along lanes plus a 32-row
    carry — both fully vectorized. Applies when the zig-zag delta span packs
    into <= 32 bits (sequential/clustered keys pack to 1-2 bits: the
    reference's bitpacking.cpp DELTA_FOR capability, beaten on footprint).
    """

    name = "delta"

    def _codes(self, values: np.ndarray):
        u = _uint_view(values)
        w = u.dtype.itemsize * 8
        d = np.empty_like(u)
        d[0] = 0
        d[1:] = u[1:] - u[:-1]  # wrap-around exact mod 2^w
        s = d.view(f"i{u.dtype.itemsize}")
        zz = ((s << 1) ^ (s >> (w - 1))).view(u.dtype)  # zig-zag
        return zz, u[0]

    def analyze(self, values: np.ndarray, ltype, cfg) -> Optional[int]:
        if values.size < 2 or values.dtype.kind not in "iu":
            return None
        zz, _ = self._codes(values)
        span = int(zz.max())
        if span >= (1 << 32):
            return None
        w = bitpack.width_for_span(
            span, cfg.succinct_padded_to_next_byte_enabled if cfg else False)
        return w * bitpack.lanes_for(values.size) * 4 + 8

    def encode(self, values: np.ndarray, ltype, cfg) -> Encoded:
        n = values.shape[0]
        zz, base = self._codes(values)
        span = int(zz.max())
        if span >= (1 << 32):
            raise ValueError("delta codec needs zig-zag deltas < 2^32")
        w = bitpack.width_for_span(
            span, cfg.succinct_padded_to_next_byte_enabled if cfg else False)
        n_lanes = bitpack.lanes_for(n)
        words = bitpack.pack(bitpack.pad_codes(zz.astype(np.uint32)
                                               if zz.dtype != np.uint32 else zz,
                                               n_lanes), width=w)
        base_arr = jnp.asarray(base)  # storage-width unsigned scalar
        nbytes = w * n_lanes * 4 + values.dtype.itemsize
        meta = (self.name, w, n_lanes, str(values.dtype))
        return Encoded(self.name, meta, (words, base_arr), n, nbytes)

    def arg_count(self, meta) -> int:
        return 2

    def make_decoder(self, meta, compute_dtype):
        _, w, n_lanes, dtype = meta
        udt = jnp.dtype(f"uint{np.dtype(dtype).itemsize * 8}")
        bits = np.dtype(dtype).itemsize * 8

        def decode(args):
            words, base = args
            zz = bitpack.unpack(words, width=w).astype(udt)  # (ROWS, L)
            # un-zig-zag in unsigned arithmetic
            d = (zz >> 1) ^ (-(zz & 1)).astype(udt)
            # prefix sum in element order: cumsum along lanes + row carry
            row = jnp.cumsum(d, axis=1, dtype=udt)
            carry = jnp.cumsum(row[:, -1], dtype=udt)
            carry = jnp.concatenate([jnp.zeros((1,), udt), carry[:-1]])
            v = row + carry[:, None] + base.astype(udt)
            return v.reshape(-1).astype(compute_dtype)

        return decode

    def gather(self, enc: Encoded, idx: jax.Array) -> jax.Array:
        # random access needs the prefix; decode fully then take (segments
        # are VMEM-tile sized, this stays cheap and on-device)
        dec = self.make_decoder(enc.meta, jnp.dtype(enc.meta[3]))
        return dec(enc.arrays)[idx]


class DictionaryCodec:
    """Distinct-value LUT + bit-packed codes (dictionary_compression.cpp
    parity for low-cardinality integer segments; VARCHAR is dictionary-
    encoded at ingest by the column layer already)."""

    name = "dictionary"

    def analyze(self, values: np.ndarray, ltype, cfg) -> Optional[int]:
        if values.size == 0 or values.dtype.kind not in "iu":
            return None
        uniq = np.unique(values)
        card = len(uniq)
        if card <= 1 or card > min(1 << 16, values.size // 4):
            return None
        c_pad = _pow2_at_least(card)
        w = bitpack.width_for_span(card - 1)
        return w * bitpack.lanes_for(values.size) * 4 + \
            c_pad * values.dtype.itemsize

    def encode(self, values: np.ndarray, ltype, cfg) -> Encoded:
        n = values.shape[0]
        uniq, codes = np.unique(values, return_inverse=True)
        card = len(uniq)
        c_pad = _pow2_at_least(card)
        lut = np.concatenate([uniq, np.full(c_pad - card, uniq[-1],
                                            dtype=values.dtype)])
        w = bitpack.width_for_span(card - 1)
        n_lanes = bitpack.lanes_for(n)
        words = bitpack.pack(
            bitpack.pad_codes(codes.astype(np.uint32), n_lanes), width=w)
        nbytes = w * n_lanes * 4 + c_pad * values.dtype.itemsize
        meta = (self.name, w, c_pad, n_lanes, str(values.dtype))
        return Encoded(self.name, meta, (words, jnp.asarray(lut)), n, nbytes)

    def arg_count(self, meta) -> int:
        return 2

    def make_decoder(self, meta, compute_dtype):
        _, w, c_pad, n_lanes, _ = meta

        def decode(args):
            words, lut = args
            codes = bitpack.unpack(words, width=w).reshape(-1)
            return lut[codes].astype(compute_dtype)

        return decode

    def gather(self, enc: Encoded, idx: jax.Array) -> jax.Array:
        _, w, c_pad, n_lanes, _ = enc.meta
        words, lut = enc.arrays
        codes = bitpack.gather_codes(words, idx, width=w, n_lanes=n_lanes)
        return lut[codes]


class AlpCodec:
    """Exact decimal-scaled floats -> FOR bit-packed ints (ALP scheme).

    Covers the reference's float codecs (chimp/, patas.cpp) with a
    vectorizable design: chimp's XOR chain decodes serially, which a vector unit
    cannot pipeline; ALP decodes as one multiply after an integer unpack.
    Only applied when ``round(v * 10^e) / 10^e`` reproduces every bit.
    """

    name = "alp"
    _MAX_E = 14

    def _plan(self, values: np.ndarray):
        if values.dtype.kind != "f" or values.size == 0:
            return None
        if not np.isfinite(values).all():
            return None
        v64 = values.astype(np.float64)
        for e in range(0, self._MAX_E + 1):
            scale = 10.0 ** e
            scaled = v64 * scale
            if np.abs(scaled).max() >= float(1 << 62):
                return None
            ints = np.round(scaled)
            if np.array_equal((ints / scale).astype(values.dtype), values):
                lo, hi = int(ints.min()), int(ints.max())
                return e, ints.astype(np.int64), lo, hi
        return None

    def analyze(self, values: np.ndarray, ltype, cfg) -> Optional[int]:
        plan = self._plan(values)
        if plan is None:
            return None
        e, ints, lo, hi = plan
        widths, _ = segcodec.plan_widths(lo, hi, 8)
        return segcodec.packed_nbytes(widths, bitpack.lanes_for(values.size)) + 16

    def encode(self, values: np.ndarray, ltype, cfg) -> Encoded:
        e, ints, lo, hi = self._plan(values)
        packed = segcodec.pack_segment(jnp.asarray(ints), _I64_LIKE,
                                       vmin=lo, vmax=hi)
        # scale rides as a *runtime* operand: a compile-time constant divisor
        # gets strength-reduced by XLA to multiply-by-reciprocal, which is
        # inexact (5941/100 != 5941*0.01); runtime divisors stay true fdiv
        arrays = tuple(w for w in packed.words if w is not None) + (
            jnp.asarray(packed.min_factor, dtype=jnp.int64),
            jnp.asarray(10.0 ** e, dtype=jnp.float64))
        meta = (self.name, packed.widths, packed.n_lanes, e,
                str(values.dtype))
        return Encoded(self.name, meta, arrays, values.shape[0],
                       packed.nbytes + 16)

    def arg_count(self, meta) -> int:
        _, widths, _, _, _ = meta
        return sum(1 for w in widths if w > 0) + 2  # + min_factor + scale

    def make_decoder(self, meta, compute_dtype):
        _, widths, n_lanes, e, dtype = meta
        n_pad = ROWS * n_lanes

        def decode(args):
            mf, scale = args[-2], args[-1]
            ws, i = [], 0
            for w in widths:
                if w == 0:
                    ws.append(None)
                else:
                    ws.append(args[i])
                    i += 1
            if all(w == 0 for w in widths):
                ints = segcodec.decode_constant(mf, n_pad, jnp.int64)
            else:
                ints = segcodec.decode_traced(tuple(ws), mf, widths=widths,
                                              compute_dtype=jnp.int64)
            return (ints.astype(jnp.float64) / scale).astype(compute_dtype)

        return decode

    def gather(self, enc: Encoded, idx: jax.Array) -> jax.Array:
        dec = self.make_decoder(enc.meta, jnp.dtype(enc.meta[4]))
        return dec(enc.arrays)[idx]

    def decode_host(self, enc: Encoded) -> np.ndarray:
        """Exact decode on the HOST (IEEE f64 division).

        Materialization decodes on the host: the segment keeps host values
        for the latency tier anyway (storage/segment.py host_plain), so no
        device round trip is needed."""
        _, widths, n_lanes, e, dtype = enc.meta
        # integer pull is exact regardless of backend
        ints = np.asarray(_decode_ints_host(enc)).astype(np.int64)
        return (ints[: enc.count].astype(np.float64) /
                np.float64(10.0 ** e)).astype(np.dtype(dtype))


def _decode_ints_host(enc: Encoded):
    """ALP helper: decode the packed integer planes (device ints are exact)."""
    _, widths, n_lanes, e, dtype = enc.meta
    mf = enc.arrays[-2]
    ws, i = [], 0
    for w in widths:
        if w == 0:
            ws.append(None)
        else:
            ws.append(enc.arrays[i])
            i += 1
    if all(w == 0 for w in widths):
        return segcodec.decode_constant(mf, ROWS * n_lanes, jnp.int64)
    return segcodec.decode_traced(tuple(ws), mf, widths=widths,
                                  compute_dtype=jnp.int64)


@dataclasses.dataclass(frozen=True)
class _I64Like:
    signed: bool = True


_I64_LIKE = _I64Like()


# ======================================================================
# registry + selection
# ======================================================================

REGISTRY: Dict[str, object] = {
    c.name: c
    for c in (ConstantCodec(), RleCodec(), DeltaCodec(), DictionaryCodec(),
              AlpCodec())
}

#: codecs eligible for automatic selection, tried in this order
AUTO_ORDER = ("constant", "rle", "delta", "dictionary", "alp")


def analyze_all(values: np.ndarray, ltype, cfg) -> Dict[str, int]:
    """Estimated packed bytes per applicable codec (succinct/uncompressed
    are computed from segment stats by the caller)."""
    out = {}
    for name in AUTO_ORDER:
        est = REGISTRY[name].analyze(values, ltype, cfg)
        if est is not None:
            out[name] = est
    return out


def detect_best_codec(values: np.ndarray, ltype, cfg,
                      succinct_bytes: Optional[int]) -> tuple[str, int]:
    """ColumnDataCheckpointer::DetectBestCompressionMethod parity: smallest
    analyzed size wins; ties break toward the cheaper decoder (AUTO_ORDER).
    Returns (codec_name, estimated_bytes); 'succinct' or 'uncompressed' when
    nothing beats them."""
    plain = values.size * values.dtype.itemsize
    best_name, best_bytes = "uncompressed", plain
    if succinct_bytes is not None and succinct_bytes < best_bytes:
        best_name, best_bytes = "succinct", succinct_bytes
    for name, est in analyze_all(values, ltype, cfg).items():
        if est < best_bytes:
            best_name, best_bytes = name, est
    return best_name, best_bytes


def encode(name: str, values: np.ndarray, ltype, cfg) -> Encoded:
    return REGISTRY[name].encode(values, ltype, cfg)


def arg_count(meta) -> int:
    return REGISTRY[meta[0]].arg_count(meta)


def make_decoder(meta, compute_dtype):
    return REGISTRY[meta[0]].make_decoder(meta, compute_dtype)


def decode_full(enc: Encoded, compute_dtype) -> jax.Array:
    dec = make_decoder(enc.meta, compute_dtype)
    return _decode_full_jit(enc.meta, compute_dtype, enc.count, enc.arrays)


@functools.lru_cache(maxsize=512)
def _full_kernel(meta, compute_dtype, count):
    dec = make_decoder(meta, compute_dtype)

    @jax.jit
    def k(args):
        return dec(args)[:count]

    return k


def _decode_full_jit(meta, compute_dtype, count, arrays):
    return _full_kernel(meta, jnp.dtype(compute_dtype), count)(arrays)


def gather(enc: Encoded, idx: jax.Array) -> jax.Array:
    return REGISTRY[enc.codec].gather(enc, idx)


def decode_full_host(enc: Encoded, compute_dtype) -> np.ndarray:
    """Exact host materialization: codecs with a host decoder (ALP) decode
    on the host; the rest pull the device decode."""
    c = REGISTRY[enc.codec]
    if hasattr(c, "decode_host"):
        return c.decode_host(enc).astype(compute_dtype, copy=False)
    return np.asarray(decode_full(enc, compute_dtype))
