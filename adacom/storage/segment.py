"""ColumnSegment: the unit of storage, compaction, and access tracking.

Parity with the reference's ColumnSegment (src/storage/table/column_segment.cpp,
846 LoC): a fixed-capacity run of one column's rows that flips in place
between an uncompressed and a succinct (bit-packed) representation
(Compact()/Uncompact(), column_segment.cpp:273,324), carries zonemap
min/max statistics, counts read accesses for the adaptive policy, and
reports its footprint to the buffer manager.

Differences from the reference:
- the representation is an immutable device-array struct; Compact() builds
  the new representation and atomically swaps one reference, so concurrent
  scans keep a consistent snapshot (fixes the reference's data race on the
  function-pointer swap guarded only by bit_compression_lock,
  column_segment.cpp:451-494);
- decode is exposed as *traceable* readers so the executor can fuse
  decode + filter + aggregate into one XLA computation (the reference's
  scan/predicate are adjacent but separate, SURVEY.md §3.2);
- segments can page out to host RAM under a memory limit (the reference's
  buffer-manager spill).
"""

from __future__ import annotations

import threading
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from adacom import types as tt
from adacom.ops import bitpack, codecs, segcodec

PLAIN = "plain"
PACKED = "packed"


def compute_dtype_for(np_dtype: np.dtype) -> np.dtype:
    """Device compute dtype for a storage dtype (ints widen to 32-bit)."""
    if np_dtype.kind == "i":
        return np.dtype(np.int32) if np_dtype.itemsize <= 4 else np.dtype(np.int64)
    if np_dtype.kind == "u":
        return np.dtype(np.uint32) if np_dtype.itemsize <= 4 else np.dtype(np.uint64)
    return np_dtype


class ColumnSegment:
    """A sealed, immutable-content run of rows for one column."""

    def __init__(
        self,
        ltype: tt.LogicalType,
        values: np.ndarray,
        config,
        buffer_manager,
        validity: Optional[np.ndarray] = None,
        start_row: int = 0,
    ):
        self.ltype = ltype
        self.config = config
        self.bm = buffer_manager
        self.count = int(values.shape[0])
        self.start_row = start_row
        self.compute_dtype = compute_dtype_for(ltype.np_dtype)
        self._lock = threading.RLock()

        # access statistics (reference AccessStatistics.num_reads);
        # written under self._lock by scans and the policy thread
        self.num_reads = 0

        # validity: None == all rows valid
        self.null_count = 0
        self._validity_np: Optional[np.ndarray] = None
        if validity is not None and not validity.all():
            self._validity_np = np.ascontiguousarray(validity.astype(np.bool_))
            self.null_count = int((~self._validity_np).sum())
            # null slots must not pollute stats/packing: fill with a valid value
            values = values.copy()
            if self.count > self.null_count:
                fill = values[self._validity_np][0]
            else:
                fill = np.zeros((), dtype=values.dtype)
            values[~self._validity_np] = fill

        # zonemap stats over valid rows (host-side numpy, computed once)
        if self.count:
            if ltype.np_dtype.kind in "iu":
                self.vmin = int(values.min())
                self.vmax = int(values.max())
            else:
                self.vmin = float(values.min())
                self.vmax = float(values.max())
        else:
            self.vmin = self.vmax = 0

        # the reference gates succinct on integer types + config
        # (CreateTransientSegment, column_segment.cpp:45-82). VARCHAR
        # segments here hold u32 dictionary codes, so FOR-bit-packing them
        # is the reference's dictionary compression (codes packed at
        # minimal width, dictionary_compression.cpp) — included.
        self.succinct_possible = bool(
            (ltype.integer or ltype.is_string) and config.succinct_enabled)

        # representation (exactly one of these is set when resident)
        self._state = PLAIN
        # codec used when compacted: "succinct" (PackedData fast path) or a
        # generic registry codec (ops/codecs.py); None while plain
        self.codec: Optional[str] = None
        self._encx: Optional[codecs.Encoded] = None
        self._encx_nbytes: Optional[int] = None  # survives page-out
        self._plain: Optional[jax.Array] = None
        self._packed: Optional[segcodec.PackedData] = None
        self._validity_dev: Optional[jax.Array] = None
        # host copy for page-in (kept in storage dtype: cheapest RAM form)
        self._host_values: np.ndarray = np.ascontiguousarray(values)
        self._paged_out = True  # starts on host; first access uploads

        self.version = 0

    # ------------------------------------------------------------------
    # state & footprint
    # ------------------------------------------------------------------
    @property
    def state(self) -> str:
        return self._state

    def is_compacted(self) -> bool:
        return self._state == PACKED

    def device_nbytes(self) -> int:
        n = 0
        if self._plain is not None:
            n += self._plain.size * self._plain.dtype.itemsize
        if self._packed is not None:
            n += self._packed.nbytes
        if self._encx is not None:
            n += self._encx.nbytes
        if self._validity_dev is not None:
            n += self._validity_dev.size * 4
        return n

    def footprint_bytes(self) -> int:
        """Logical data footprint (reference GetDataSize accounting):
        packed bytes when compacted, plain bytes otherwise. Valid whether or
        not the segment is device-resident."""
        if self._state == PACKED:
            if self.codec not in (None, "succinct"):
                if self._encx is not None:
                    return self._encx.nbytes
                if self._encx_nbytes is not None:
                    return self._encx_nbytes
            if self._packed is not None:
                return self._packed.nbytes
            widths, _ = segcodec.plan_widths(
                self.vmin, self.vmax, self.compute_dtype.itemsize,
                extract_prefix=self.config.succinct_extract_prefix_enabled,
                padded_to_byte=self.config.succinct_padded_to_next_byte_enabled,
            )
            return segcodec.packed_nbytes(widths, bitpack.lanes_for(self.count))
        return self.count * self.compute_dtype.itemsize

    # ------------------------------------------------------------------
    # residency
    # ------------------------------------------------------------------
    def _ensure_resident(self) -> None:
        with self._lock:
            if not self._paged_out:
                self.bm.touch(self)
                return
            arr = jnp.asarray(self._host_values.astype(self.compute_dtype))
            if self._validity_np is not None:
                # width-1 pack the validity bitmap on device
                bits = jnp.asarray(self._validity_np.astype(np.uint32))
                self._validity_dev = bitpack.pack(
                    bitpack.pad_codes(bits, bitpack.lanes_for(self.count)), width=1
                )
            if self._state == PACKED:
                if self.codec not in (None, "succinct"):
                    self._encx = codecs.encode(
                        self.codec, self._host_compute_values(), self.ltype,
                        self.config)
                    self._encx_nbytes = self._encx.nbytes
                else:
                    self._packed = self._pack_from(arr)
                self._plain = None
            else:
                self._plain = arr
                self._packed = None
            self._paged_out = False
            self.bm.notify_alloc(self, self.device_nbytes())

    def try_page_out(self) -> int:
        """Non-blocking page_out for the buffer manager's eviction sweep
        (avoids lock-order inversion with segments busy elsewhere)."""
        if not self._lock.acquire(blocking=False):
            return 0
        try:
            return self._page_out_locked()
        finally:
            self._lock.release()

    def page_out(self) -> int:
        """Drop device residency (host copy is authoritative). Returns bytes
        freed; called by the buffer manager under memory pressure."""
        with self._lock:
            return self._page_out_locked()

    def _page_out_locked(self) -> int:
        if self._paged_out:
            return 0
        freed = self.device_nbytes()
        self._plain = None
        self._packed = None
        self._encx = None
        self._validity_dev = None
        self._paged_out = True
        self.version += 1
        return freed

    # ------------------------------------------------------------------
    # compaction state machine (reference Compact()/Uncompact())
    # ------------------------------------------------------------------
    def _pack_from(self, arr: jax.Array) -> segcodec.PackedData:
        return segcodec.pack_segment(
            arr,
            self.ltype,
            extract_prefix=self.config.succinct_extract_prefix_enabled,
            padded_to_byte=self.config.succinct_padded_to_next_byte_enabled,
            vmin=self.vmin if isinstance(self.vmin, int) else None,
            vmax=self.vmax if isinstance(self.vmax, int) else None,
        )

    def _host_compute_values(self) -> np.ndarray:
        return self._host_values.astype(self.compute_dtype, copy=False)

    def _resolve_codec(self, codec: Optional[str]) -> Optional[str]:
        """Pick the compaction codec: explicit arg > force_compression >
        config.compression_codec ('auto' = analyze-based selection,
        DetectBestCompressionMethod parity)."""
        if codec is None:
            codec = self.config.force_compression
        if codec is None:
            codec = getattr(self.config, "compression_codec", "succinct")
        codec = codec.lower()
        if codec == "succinct":
            return "succinct" if self.succinct_possible else None
        if codec == "uncompressed":
            return None
        if codec == "auto":
            vals = self._host_compute_values()
            succ_bytes = None
            if self.succinct_possible:
                widths, _ = segcodec.plan_widths(
                    self.vmin, self.vmax, self.compute_dtype.itemsize,
                    extract_prefix=self.config.succinct_extract_prefix_enabled,
                    padded_to_byte=self.config.succinct_padded_to_next_byte_enabled,
                )
                succ_bytes = segcodec.packed_nbytes(
                    widths, bitpack.lanes_for(self.count))
            best, _ = codecs.detect_best_codec(
                vals, self.ltype, self.config, succ_bytes)
            return None if best == "uncompressed" else best
        if codec not in codecs.REGISTRY:
            raise ValueError(f"unknown compression codec: {codec}")
        if codecs.REGISTRY[codec].analyze(
                self._host_compute_values(), self.ltype, self.config) is None:
            return None
        return codec

    def compact(self, codec: Optional[str] = None) -> bool:
        """Compress in place. Returns True if the state changed.

        Reference Compact() (column_segment.cpp:273) always bit-compresses
        succinct; here the codec is pluggable (registry in ops/codecs.py)
        and 'auto' picks the smallest analyzed representation."""
        if self.count == 0:
            return False
        with self._lock:
            if self._state == PACKED:
                return False
            resolved = self._resolve_codec(codec)
            if resolved is None:
                return False
            before = self.footprint_bytes()
            self.codec = resolved
            if self._paged_out:
                if resolved != "succinct":
                    # need real nbytes for accounting: encode once, drop
                    est = codecs.REGISTRY[resolved].analyze(
                        self._host_compute_values(), self.ltype, self.config)
                    self._encx_nbytes = est
                self._state = PACKED  # materializes on page-in
            else:
                old_bytes = self.device_nbytes()
                if resolved != "succinct":
                    self._encx = codecs.encode(
                        resolved, self._host_compute_values(), self.ltype,
                        self.config)
                    self._encx_nbytes = self._encx.nbytes
                else:
                    arr = self._plain
                    if arr is None:
                        arr = jnp.asarray(self._host_compute_values())
                    self._packed = self._pack_from(arr)
                self._plain = None
                self._state = PACKED
                self.bm.notify_free(self, old_bytes)
                self.bm.notify_alloc(self, self.device_nbytes())
            self.version += 1
            self.bm.add_to_data_size(self.footprint_bytes() - before)
            return True

    def uncompact(self) -> bool:
        """Restore the uncompressed representation (hot segments)."""
        with self._lock:
            if self._state == PLAIN:
                return False
            before = self.footprint_bytes()
            if self._paged_out:
                self._state = PLAIN
            else:
                old_bytes = self.device_nbytes()
                if self._encx is not None:
                    self._plain = codecs.decode_full(self._encx,
                                                     self.compute_dtype)
                else:
                    self._plain = segcodec.unpack_segment(
                        self._packed, self.compute_dtype)
                self._packed = None
                self._encx = None
                self._state = PLAIN
                self.bm.notify_free(self, old_bytes)
                self.bm.notify_alloc(self, self.device_nbytes())
            self.codec = None
            self._encx_nbytes = None
            self.version += 1
            self.bm.add_to_data_size(self.footprint_bytes() - before)
            return True

    # ------------------------------------------------------------------
    # scan interface
    # ------------------------------------------------------------------
    def add_read_access(self) -> None:
        """Reference ColumnSegmentCatalog::AddReadAccess (called per scan).

        Incremented under the segment lock: a bare `+= 1` is a
        read-modify-write that concurrent scan threads could interleave
        on GIL-free builds, and the policy thread's decay
        (segment_catalog.CompressLowestKSegments) writes the same field.
        The reference's unsynchronized unordered_map was racy by
        construction (SURVEY §2.1) — this design fixes it."""
        with self._lock:
            self.num_reads += 1

    def reader_arrays(self):
        """Snapshot for fused execution: (meta, device arrays).

        meta is a hashable trace key (same representation -> same compiled
        kernel); pair with exec.executor.make_seg_decoder(meta) to rebuild
        the traceable decode — the kernel cache is keyed on meta, not on
        per-segment closures."""
        self._ensure_resident()
        self.add_read_access()
        with self._lock:
            if self._state == PACKED:
                if self._encx is not None:
                    return self._encx.meta, self._encx.arrays
                p = self._packed
                mf = p.mf_dev()
                arrays = tuple(w for w in p.words if w is not None) + (mf,)
                return ("packed", p.meta), arrays
            arr = self._plain
            return ("plain", str(arr.dtype), int(arr.shape[0])), (arr,)

    def validity_arrays(self):
        """Packed validity words for fused kernels; None when all valid."""
        if self._validity_np is None:
            return None
        self._ensure_resident()
        return (self._validity_dev,)

    def reader(self):
        """Snapshot for fused execution: (meta, arrays, traceable decode).

        meta is a hashable trace key; arrays is the tuple of device inputs;
        the returned `decode(*arrays)` closure is traceable inside jit and
        yields the padded flat value array (ROWS*L elements; rows beyond
        `count` are garbage and must be masked by the caller).
        """
        self._ensure_resident()
        self.add_read_access()
        with self._lock:
            if self._state == PACKED and self._encx is not None:
                enc = self._encx
                return enc.meta, enc.arrays, codecs.make_decoder(
                    enc.meta, self.compute_dtype)
            if self._state == PACKED:
                p = self._packed
                meta = ("packed", p.meta)
                mf = p.mf_dev()
                arrays = tuple(w for w in p.words if w is not None) + (mf,)
                widths = p.widths
                cdt = self.compute_dtype
                n_pad = bitpack.ROWS * p.n_lanes

                def decode(*args):
                    mfv = args[-1]
                    ws = []
                    i = 0
                    for w in widths:
                        if w == 0:
                            ws.append(None)
                        else:
                            ws.append(args[i])
                            i += 1
                    if all(w == 0 for w in widths):
                        return segcodec.decode_constant(mfv, n_pad, cdt)
                    return segcodec.decode_traced(
                        tuple(ws), mfv, widths=widths, compute_dtype=cdt
                    ).astype(cdt)

                return meta, arrays, decode
            else:
                arr = self._plain
                meta = ("plain", str(arr.dtype), arr.shape[0])

                def decode(a):
                    return a

                return meta, (arr,), decode

    def host_plain(self) -> np.ndarray:
        """Host copy in compute dtype — the latency tier for selective point
        lookups (device roundtrips cost more than a SIMD scan of one
        segment). Counts as a read access for the adaptive policy."""
        self.add_read_access()
        return self._host_values.astype(self.compute_dtype, copy=False)

    def host_validity(self) -> Optional[np.ndarray]:
        return self._validity_np

    def validity_reader(self):
        """Like reader() but for the validity bitmap; None if all valid."""
        if self._validity_np is None:
            return None
        self._ensure_resident()
        v = self._validity_dev

        def decode(words):
            return bitpack.unpack(words, width=1).reshape(-1)

        return ("validity", v.shape), (v,), decode

    def decoded(self) -> jax.Array:
        """Whole-segment decode to the compute dtype (count rows)."""
        self._ensure_resident()
        self.add_read_access()
        with self._lock:
            if self._state == PACKED:
                if self._encx is not None:
                    return codecs.decode_full(self._encx, self.compute_dtype)
                return segcodec.unpack_segment(self._packed, self.compute_dtype)
            return self._plain

    def fetch_rows(self, idx: np.ndarray) -> np.ndarray:
        """Random row access (reference FetchRow)."""
        self._ensure_resident()
        self.add_read_access()
        with self._lock:
            if self._state == PACKED:
                if self._encx is not None:
                    out = codecs.gather(self._encx, jnp.asarray(idx))
                else:
                    out = segcodec.gather_segment(self._packed, jnp.asarray(idx))
            else:
                out = self._plain[jnp.asarray(idx)]
        return np.asarray(out)

    # zonemap check (reference CheckZonemapSegments, row_group.cpp:287)
    def zonemap_may_match(self, op: str, value) -> bool:
        if self.count == 0:
            return False
        try:
            if op == "=":
                return self.vmin <= value <= self.vmax
            if op in ("<", "<="):
                return self.vmin < value or (op == "<=" and self.vmin <= value)
            if op in (">", ">="):
                return self.vmax > value or (op == ">=" and self.vmax >= value)
        except TypeError:
            return True
        return True

    def __repr__(self):
        return (
            f"<Segment {self.ltype} rows={self.count} state={self._state} "
            f"reads={self.num_reads} bytes={self.footprint_bytes()}>"
        )
