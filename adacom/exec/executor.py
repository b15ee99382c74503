"""Query executor: logical plan -> fused jitted device stages + host glue.

Parity with the reference's physical planner + pipeline executor
(src/execution/physical_plan_generator.cpp, src/parallel/pipeline_executor.cpp):
each LogicalGet becomes a streaming source over column segments; filters and
group/aggregate expressions fuse with segment *decode* into one XLA kernel
per (segment representation, plan template) — the device version of
the reference's scan hot loop (RowGroup::TemplatedScan, row_group.cpp:324-457)
with the decode+predicate fusion it lacks. Zonemap skipping
(CheckZonemapSegments, row_group.cpp:287) happens host-side over vectorized
per-table stats. Joins/sorts run as vectorized host operators this
milestone (device radix variants are later milestones; see SURVEY.md §7).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from adacom import types as tt
from adacom.ops import agg as agg_ops
from adacom.ops import bitpack, codecs, segcodec
from adacom.ops.select import compact_traced, tail_mask
from adacom.sql import bound as b
from adacom.exec.expr import ExprCompiler, CompiledExpr, compute_dtype_of

# Dense group domains above this size with fewer than
# DBConfig.device_agg_min_rows rows aggregate on the host when an
# accelerator is present (inherited thresholds, not yet measured on a GPU;
# ROADMAP 1.3).
HOST_AGG_DOMAIN = 16


# ======================================================================
# materialized batches
# ======================================================================


@dataclasses.dataclass
class Mat:
    names: List[str]
    types: List[tt.LogicalType]
    dicts: List[Any]
    cols: List[np.ndarray]
    valids: List[Optional[np.ndarray]]

    @property
    def nrows(self) -> int:
        return len(self.cols[0]) if self.cols else self._nrows

    _nrows: int = 0

    @classmethod
    def empty_like(cls, node: b.LogicalOp) -> "Mat":
        dicts = getattr(node, "dicts", [None] * len(node.names))
        return cls(
            list(node.names), list(node.types), list(dicts),
            [np.empty(0, compute_dtype_of(t)) for t in node.types],
            [None] * len(node.names),
        )

    def take(self, idx: np.ndarray) -> "Mat":
        return Mat(
            self.names, self.types, self.dicts,
            [c[idx] for c in self.cols],
            [None if v is None else v[idx] for v in self.valids],
        )


# ======================================================================
# segment decoding from meta (pure functions of the static trace key)
# ======================================================================


def seg_arg_count(meta) -> int:
    kind = meta[0]
    if kind == "plain":
        return 1
    if kind == "packed":
        widths, n_lanes, dtype = meta[1]
        return sum(1 for w in widths if w > 0) + 1  # words... + min_factor
    if kind in codecs.REGISTRY:  # generic codec framework (ops/codecs.py)
        return codecs.arg_count(meta)
    raise ValueError(meta)


def make_seg_decoder(meta, compute_dtype):
    kind = meta[0]
    if kind == "plain":
        def decode(args):
            return args[0]
        return decode
    if kind in codecs.REGISTRY:
        return codecs.make_decoder(meta, compute_dtype)
    widths, n_lanes, dtype = meta[1]
    n_pad = bitpack.ROWS * n_lanes

    def decode(args):
        mf = args[-1]
        ws = []
        i = 0
        for w in widths:
            if w == 0:
                ws.append(None)
            else:
                ws.append(args[i])
                i += 1
        if all(w == 0 for w in widths):
            return segcodec.decode_constant(mf, n_pad, compute_dtype)
        return segcodec.decode_traced(
            tuple(ws), mf, widths=widths, compute_dtype=compute_dtype
        )
    return decode


# ======================================================================
# executor
# ======================================================================


class ExecError(Exception):
    pass


class _FallbackToDevice(Exception):
    """Internal: a host morsel hit a non-numpy path; rerun on device."""


class Executor:
    def __init__(self, database):
        self.db = database
        self.config = database.config
        # per-operator profiling sink: id(node) -> (inclusive_s, rows_out)
        # (reference OperatorProfiler, src/main/query_profiler.cpp; enabled
        # by EXPLAIN ANALYZE / PRAGMA enable_profiling)
        self.profile: Optional[Dict[int, tuple]] = None

    # ------------------------------------------------------------------
    def execute(self, plan: b.LogicalOp, lits: List[Any]) -> Mat:
        self._prepare_subqueries(plan, lits)
        return self._exec(plan, lits)

    def _prepare_subqueries(self, plan: b.LogicalOp, lits) -> None:
        """Evaluate uncorrelated scalar/exists/in subqueries and stash their
        results on the BSubquery nodes before compiled expressions run."""
        has = getattr(plan, "_has_subqueries", None)
        if has is False:  # cached: plan contains none (point-lookup hot path)
            return
        if has is None:
            plan._has_subqueries = any(
                isinstance(sq, b.BSubquery)
                for node in b.walk(plan)
                for e in b.iter_node_exprs(node)
                for sq in b.expr_walk(e)
            )
            if not plan._has_subqueries:
                return
        for node in b.walk(plan):
            for e in b.iter_node_exprs(node):
                for sq in b.expr_walk(e):
                    if not isinstance(sq, b.BSubquery):
                        continue
                    mat = self.execute(sq.plan, lits)
                    if sq.kind == "exists":
                        hit = mat.nrows > 0
                        sq.cached_value = np.asarray(not hit if sq.negated else hit)
                    elif sq.kind == "scalar":
                        if mat.nrows == 0 or (
                            mat.valids[0] is not None and not mat.valids[0][0]
                        ):
                            sq.cached_value = None
                        else:
                            sq.cached_value = np.asarray(mat.cols[0][0])
                    else:  # 'in' not rewritten to a join: membership array
                        col = mat.cols[0]
                        if mat.valids[0] is not None:
                            col = col[mat.valids[0]]
                        sq.cached_value = np.unique(col)

    def _exec(self, node: b.LogicalOp, lits) -> Mat:
        if self.profile is None:
            return self._dispatch(node, lits)
        import time as _time

        t0 = _time.perf_counter()
        mat = self._dispatch(node, lits)
        dt, rows = _time.perf_counter() - t0, mat.nrows
        prev = self.profile.get(id(node))
        if prev is not None:  # node re-executed (e.g. subquery): accumulate
            dt, rows = dt + prev[0], rows + prev[1]
        self.profile[id(node)] = (dt, rows)
        return mat

    def _dispatch(self, node: b.LogicalOp, lits) -> Mat:
        if isinstance(node, b.LogicalGet):
            return self._materialize_scan(node, lits)
        if isinstance(node, b.LogicalSample):
            return self._exec_sample(node, lits)
        if isinstance(node, b.LogicalValues):
            return self._exec_values(node, lits)
        if isinstance(node, b.LogicalFilter):
            return self._exec_filter(node, lits)
        if isinstance(node, b.LogicalProject):
            return self._exec_project(node, lits)
        if isinstance(node, b.LogicalAggregate):
            return self._exec_aggregate(node, lits)
        if isinstance(node, b.LogicalJoin):
            return self._exec_join(node, lits)
        if isinstance(node, b.LogicalOrder):
            return self._exec_order(node, lits)
        if isinstance(node, b.LogicalTopN):
            return self._exec_topn(node, lits)
        if isinstance(node, b.LogicalLimit):
            return self._exec_limit(node, lits)
        if isinstance(node, b.LogicalDistinct):
            return self._exec_distinct(node, lits)
        if isinstance(node, b.LogicalSetOp):
            return self._exec_setop(node, lits)
        if isinstance(node, b.LogicalWindow):
            return self._exec_window(node, lits)
        raise ExecError(f"no executor for {type(node).__name__}")

    # ==================================================================
    # scans
    # ==================================================================

    def _compiled_filter(self, get: b.LogicalGet) -> Optional[CompiledExpr]:
        cache = getattr(get, "_filter_cc", None)
        if cache is not None:
            return cache or None
        if not get.filters:
            get._filter_cc = False
            return None
        cond = get.filters[0]
        for c in get.filters[1:]:
            cond = b.BBinary(tt.BOOLEAN, "and", cond, c)
        cc = ExprCompiler().compile(cond)
        get._filter_cc = cc
        return cc

    def _pin_snapshot(self, table):
        """Pin a consistent TableSnapshot for this scan (storage/table.py
        TableSnapshot): segment tuples + delete masks captured atomically,
        MVCC-clamped to the committed watermark for non-owning readers.
        Every reader access below resolves through the snapshot — live
        ``columns[c].segments`` lists mutate under concurrent appends
        (unseal-partial pops the tail) and raced the round-4 scans."""
        return table.read_snapshot(getattr(self, "conn_token", None))

    def _zonemap_candidates(self, get: b.LogicalGet, lits, snap=None) -> List[int]:
        """Vectorized segment skipping from (col op literal) conjuncts
        over a pinned snapshot (the snapshot already applies the MVCC
        committed-watermark clamp)."""
        if snap is None:
            snap = self._pin_snapshot(get.table)
        n_seg = snap.segment_count()
        keep = np.ones(n_seg, dtype=bool)
        for f in get.filters:
            probe = _zonemap_probe(f, lits)
            if probe is None:
                continue
            col_idx, op, val = probe
            col_name = get.column_ids[col_idx]
            mins, maxs = self._table_zonemaps(get.table, col_name, snap)
            if op == "=":
                keep &= (mins[:n_seg] <= val) & (val <= maxs[:n_seg])
            elif op in ("<", "<="):
                keep &= mins[:n_seg] <= val if op == "<=" \
                    else mins[:n_seg] < val
            elif op in (">", ">="):
                keep &= maxs[:n_seg] >= val if op == ">=" \
                    else maxs[:n_seg] > val
        # nonzero beats a python loop at point-lookup rates (10k qps over
        # 1526 segments made the comprehension ~20% of lookup cost)
        return np.nonzero(keep)[0].tolist()

    def _vis_delete_mask(self, table, i: int):
        """Snapshot-aware delete mask: readers see the committed masks
        while a write transaction is in flight on this table."""
        limit, dels = table.snapshot_for(getattr(self, "conn_token", None))
        if dels is not None:
            return dels.get(i)
        return table.delete_mask(i)

    def _table_zonemaps(self, table, col_name, snap=None):
        segs = snap.segments(col_name) if snap is not None \
            else tuple(table.columns[col_name].segments)
        col = table.columns[col_name]
        cache = getattr(col, "_zonemap_cache", None)
        # the tail segment can be REPLACED in place (unseal-partial +
        # append reseals it larger with new bounds) without changing the
        # segment count — key on the tail's identity and count too, or a
        # stale zonemap hides freshly appended rows from scans/DML
        # (found by tools/fuzz_dml.py seed 1)
        tail = segs[-1] if segs else None
        key = (len(segs), id(tail), tail.count if tail is not None else 0)
        if cache is not None and cache[0] == key:
            return cache[1], cache[2]
        # longdouble: 64-bit mantissa keeps u64 zonemap bounds exact
        mins = np.array([s.vmin for s in segs], dtype=np.longdouble)
        maxs = np.array([s.vmax for s in segs], dtype=np.longdouble)
        col._zonemap_cache = (key, mins, maxs)
        return mins, maxs

    def _scan_batches(self, get: b.LogicalGet, lits):
        """Yield (seg_idx, count, kernel_output) per candidate segment.

        kernel_output = (mask, cols) with cols = list[(values, valid|None)],
        all padded to the segment's lane-padded length, still on device."""
        snap = self._pin_snapshot(get.table)
        filt = self._compiled_filter(get)
        params = filt.prep_args(lits) if filt is not None else ()
        candidates = self._zonemap_candidates(get, lits, snap)
        kernels = getattr(get, "_scan_kernels", None)
        if kernels is None:
            kernels = get._scan_kernels = {}
        for i in candidates:
            segs = [snap.segment(c, i) for c in get.column_ids]
            count = segs[0].count if segs else snap.segment_rows(i)
            metas = []
            arrays = []
            for s in segs:
                meta, arrs = s.reader_arrays()
                vmeta = s.validity_arrays()
                if vmeta is not None:
                    meta = (meta, "v")
                    arrs = arrs + vmeta
                else:
                    meta = (meta, None)
                metas.append(meta)
                arrays.extend(arrs)
            del_mask = snap.delete_mask(i)
            has_del = del_mask is not None
            n_pad = bitpack.ROWS * bitpack.lanes_for(count)
            key = (tuple(metas), n_pad, has_del, filt is not None)
            kern = kernels.get(key)
            if kern is None:
                kern = _build_scan_kernel(
                    tuple(metas),
                    [compute_dtype_of(t) for t in get.types],
                    filt, n_pad, has_del,
                )
                kernels[key] = kern
            extra = []
            if has_del:
                dm = np.zeros(n_pad, dtype=bool)
                dm[: len(del_mask)] = del_mask
                extra.append(jnp.asarray(dm))
            out = kern(np.int32(count), params, tuple(extra), *arrays)
            yield i, count, out

    def _materialize_scan(self, get: b.LogicalGet, lits) -> Mat:
        # host tier: selective lookups AND materializations (the output is
        # host-resident either way; the device link charges per pulled byte)
        limit = self.config.host_scan_segment_limit
        candidates = None
        if (limit and get.filters) or self.config.host_materialize:
            snap = self._pin_snapshot(get.table)
            candidates = self._zonemap_candidates(get, lits, snap)
            if self.config.host_materialize or len(candidates) <= limit:
                mat = self._materialize_scan_host(get, lits, candidates, snap)
                if mat is not None:
                    return mat
        return self._materialize_scan_device(get, lits)

    def _materialize_scan_host(self, get: b.LogicalGet, lits, candidates,
                               snap) -> Optional[Mat]:
        """NumPy evaluation over segment host copies; returns None when the
        compiled filter doesn't stay in numpy (e.g. dict LUT gathers) —
        caller falls back to the device path."""
        table = get.table
        filt = self._compiled_filter(get)
        params = filt.prep_args(lits) if filt is not None else ()
        ncols = len(get.column_ids)
        per_col: List[List[np.ndarray]] = [[] for _ in range(ncols)]
        per_valid: List[List[Optional[np.ndarray]]] = [[] for _ in range(ncols)]
        any_valid = [False] * ncols
        # single eq-conjunct fast path -> native C++ filter kernel
        eq_probe = None
        index_hits = None
        if len(get.filters) == 1:
            p = _zonemap_probe(get.filters[0], lits)
            if p is not None and p[1] == "=" and float(p[2]).is_integer():
                eq_probe = (p[0], int(p[2]))
            if p is not None and p[1] == "=":
                # index-scan rewrite (reference table_scan.cpp:388): a sorted
                # index answers the equality probe with binary searches
                idxo = table.index_on(get.column_ids[p[0]])
                if idxo is None and self.config.auto_index_threshold and \
                        len(candidates) >= 4:
                    # adaptive auto-index: repeated selective eq probes on
                    # a column whose zonemaps can't prune (e.g. the
                    # FBWorkload prefix-random u64 trace scans EVERY
                    # segment per lookup) earn a SortedIndex — the
                    # access-counter adaptivity of the segment catalog,
                    # applied to point lookups
                    colo = table.columns[get.column_ids[p[0]]]
                    probes = getattr(colo, "_eq_probe_count", 0) + 1
                    colo._eq_probe_count = probes
                    if probes >= self.config.auto_index_threshold:
                        from adacom.storage.index import SortedIndex

                        idxo = SortedIndex(
                            f"__auto_{table.name}_{colo.name}", table,
                            colo.name)
                        idxo.build()
                        table.indexes.append(idxo)
                        self.db.dist_stats["auto_index_built"] = \
                            self.db.dist_stats.get("auto_index_built", 0) + 1
                if idxo is not None:
                    index_hits = dict(idxo.lookup_eq(p[2]))
                    candidates = [i for i in candidates if i in index_hits]
        def scan_morsel(i):
            """One segment = one morsel (reference NextParallelScan hands
            out one row group per task, row_group_collection.cpp:112)."""
            segs = [snap.segment(c, i) for c in get.column_ids]
            cols = []
            for s in segs:
                hv = s.host_plain()
                hvv = s.host_validity()
                cols.append((hv, hvv))
            dm = snap.delete_mask(i)
            rows = None
            if index_hits is not None:
                rows = index_hits[i]
                v = cols[p[0]][1]
                if v is not None:  # NULL slots hold fill values: drop them
                    rows = rows[v[rows]]
                if dm is not None:
                    inb = rows < len(dm)
                    keep = np.ones(len(rows), dtype=bool)
                    keep[inb] = ~dm[rows[inb]]
                    rows = rows[keep]
            if rows is None and eq_probe is not None and dm is None:
                fcol, fval = eq_probe
                fvals, fvalid = cols[fcol]
                if fvalid is None and fvals.dtype == np.uint32 and 0 <= fval < (1 << 32):
                    from adacom import native as _native

                    rows = _native.filter_eq_u32(fvals, fval)
            if rows is None and len(get.filters) >= 2 and dm is None:
                # multi-conjunct scans: adaptive runtime-ordered conjunct
                # evaluation (reference AdaptiveFilter, adaptive_filter.cpp)
                af = getattr(get, "_adaptive_filter", None)
                if af is None:
                    from adacom.exec.adaptive_filter import AdaptiveFilter

                    af = get._adaptive_filter = AdaptiveFilter(get.filters)
                rows = af.select(cols, lits)
                if rows is None:
                    raise _FallbackToDevice()
            if rows is None:
                if filt is not None:
                    try:
                        fv, fm = filt.fn(cols, params)
                    except Exception:
                        raise _FallbackToDevice()
                    if not isinstance(fv, np.ndarray):
                        raise _FallbackToDevice()
                    mask = fv
                    if fm is not None:
                        mask = mask & fm
                else:
                    mask = np.ones(segs[0].count, dtype=bool)
                if dm is not None:
                    # the segment may have grown since rows were deleted
                    # (unseal-partial-and-append); pad the bitmap
                    dmx = np.zeros(len(mask), dtype=bool)
                    dmx[: min(len(dm), len(mask))] = dm[: len(mask)]
                    mask = mask & ~dmx
                rows = np.nonzero(mask)[0]
            return cols, rows

        from adacom.parallel.scheduler import TaskScheduler

        try:
            results = TaskScheduler.get().map_segments(
                scan_morsel, candidates, threads=self.config.threads)
        except _FallbackToDevice:
            return None
        for cols, rows in results:
            for c in range(ncols):
                per_col[c].append(cols[c][0][rows])
                v = cols[c][1]
                if v is not None:
                    any_valid[c] = True
                per_valid[c].append(None if v is None else v[rows])
        dicts = getattr(get, "dicts", [None] * ncols)
        cols_np = [
            np.concatenate(per_col[c]) if per_col[c]
            else np.empty(0, compute_dtype_of(get.types[c]))
            for c in range(ncols)
        ]
        valids_np: List[Optional[np.ndarray]] = []
        for c in range(ncols):
            if not any_valid[c]:
                valids_np.append(None)
            else:
                valids_np.append(np.concatenate([
                    v if v is not None else np.ones(len(a), bool)
                    for v, a in zip(per_valid[c], per_col[c])
                ]))
        return Mat(list(get.names), list(get.types), list(dicts), cols_np, valids_np)

    def _materialize_scan_device(self, get: b.LogicalGet, lits) -> Mat:
        ncols = len(get.column_ids)
        per_col: List[List[np.ndarray]] = [[] for _ in range(ncols)]
        per_valid: List[List[np.ndarray]] = [[] for _ in range(ncols)]
        any_valid = [False] * ncols
        counts = []
        for i, count, (mask, cols) in self._scan_batches(get, lits):
            arrays = [v for v, _ in cols]
            valid_arrays = [m for _, m in cols]
            packed = _compact_batch(mask, tuple(arrays),
                                    tuple(v for v in valid_arrays if v is not None))
            cnt_vec, outs = packed[0], packed[1]
            n = int(np.asarray(cnt_vec)[0])
            counts.append(n)
            # pull device-side slices padded to >=64 elements (tiny
            # transfers are pathological on the device link)
            m = min(outs[0].shape[0] if outs else 0, max(n, 64))
            vi = 0
            for c in range(ncols):
                per_col[c].append(np.asarray(outs[c][:m])[:n])
            rest = outs[ncols:]
            for c in range(ncols):
                if valid_arrays[c] is not None:
                    any_valid[c] = True
                    per_valid[c].append(np.asarray(rest[vi][:m])[:n])
                    vi += 1
                else:
                    per_valid[c].append(None)
        dicts = getattr(get, "dicts", [None] * ncols)
        if not counts:
            return Mat.empty_like(get)
        cols_np = [np.concatenate(per_col[c]) if per_col[c] else
                   np.empty(0, compute_dtype_of(get.types[c])) for c in range(ncols)]
        valids_np: List[Optional[np.ndarray]] = []
        for c in range(ncols):
            if not any_valid[c]:
                valids_np.append(None)
            else:
                chunks = [
                    v if v is not None else np.ones(n, dtype=bool)
                    for v, n in zip(per_valid[c], counts)
                ]
                valids_np.append(np.concatenate(chunks))
        return Mat(list(get.names), list(get.types), list(dicts), cols_np, valids_np)

    # ==================================================================
    # filter / project over materialized input
    # ==================================================================

    def _eval_on_mat(self, exprs: List[b.BExpr], mat: Mat, lits):
        """Evaluate expressions over a materialized batch.

        Small batches evaluate in numpy (device roundtrips dominate at this
        size); large batches or numpy-incompatible expressions go to the
        device."""
        ccs = []
        for e in exprs:
            cc = getattr(e, "_cc", None)
            if cc is None:
                cc = ExprCompiler().compile(e)
                e._cc = cc
            ccs.append(cc)
        if all(isinstance(c, np.ndarray) for c in mat.cols):
            cols_np = [(c, v) for c, v in zip(mat.cols, mat.valids)]
            outs = []
            ok = True
            for cc in ccs:
                try:
                    v, m = cc.fn(cols_np, cc.prep_args(lits))
                except Exception:
                    ok = False
                    break
                if not isinstance(v, (np.ndarray, np.generic, str)) or (
                    m is not None and not isinstance(m, (np.ndarray, np.generic))
                ):
                    ok = False
                    break
                outs.append((v, m))
            if ok:
                return outs
        cols = []
        for c, v in zip(mat.cols, mat.valids):
            cols.append((jnp.asarray(c), None if v is None else jnp.asarray(v)))
        outs = []
        for cc in ccs:
            args = cc.prep_args(lits)
            v, m = cc.fn(cols, args)
            outs.append((v, m))
        return outs

    def _exec_filter(self, node: b.LogicalFilter, lits) -> Mat:
        mat = self._exec(node.child, lits)
        if mat.nrows == 0:
            return mat
        (v, m), = self._eval_on_mat([node.condition], mat, lits)
        mask = np.asarray(v)
        if m is not None:
            mask = mask & np.asarray(m)
        if mask.ndim == 0:
            mask = np.full(mat.nrows, bool(mask))
        idx = np.nonzero(mask)[0]
        return mat.take(idx)

    def _exec_project(self, node: b.LogicalProject, lits) -> Mat:
        mat = self._exec(node.child, lits)
        return self._project_mat(node, mat, lits)

    def _project_mat(self, node: b.LogicalProject, mat: Mat, lits) -> Mat:
        outs = self._eval_on_mat(node.exprs, mat, lits)
        n = mat.nrows
        cols = []
        valids = []
        for (v, m), ty in zip(outs, node.types):
            a = np.asarray(v)
            if a.ndim == 0:
                a = np.full(n, a)
            cols.append(a)
            if m is None:
                valids.append(None)
            else:
                mm = np.asarray(m)
                if mm.ndim == 0:
                    mm = np.full(n, bool(mm))
                valids.append(mm if not mm.all() else None)
        dicts = getattr(node, "dicts", [None] * len(node.names))
        return Mat(list(node.names), list(node.types), list(dicts), cols, valids)

    def _exec_sample(self, node: b.LogicalSample, lits) -> Mat:
        """Deterministic-seed row sample (reservoir-sample parity; a
        fixed seed keeps repeated queries and verifier variants stable)."""
        mat = self._exec(node.child, lits)
        n = mat.nrows
        rng = np.random.default_rng(0xADAC)
        if node.is_percent:
            k = int(round(n * node.amount / 100.0))
        else:
            k = min(node.amount, n)
        if k >= n:
            return mat
        idx = np.sort(rng.choice(n, size=k, replace=False))
        out = mat.take(idx)
        out.names = list(node.names)
        return out

    def _exec_values(self, node: b.LogicalValues, lits) -> Mat:
        if not node.names:
            # SELECT without FROM: single row, no columns
            return Mat([], [], [], [], [])
        # (VALUES ...) table ref: literal rows materialize as columns
        # (reference value_relation / expression lists)
        cols: List[np.ndarray] = []
        valids: List[Optional[np.ndarray]] = []
        dicts: List[Any] = []
        for ci, ty in enumerate(node.types):
            vals = []
            for row in node.rows:
                ex = row[ci]
                if not isinstance(ex, b.BLiteral):
                    raise ExecError("VALUES cells must be literals")
                v = lits[ex.param] if ex.param is not None else ex.value
                vals.append(v)
            mask = np.asarray([v is not None for v in vals])
            if ty.is_string:
                # cells are dictionary CODES (binder encoded the strings)
                cols.append(np.asarray(
                    [0 if v is None else int(v) for v in vals],
                    dtype=np.uint32))
                dicts.append(getattr(node, "dicts",
                                     [None] * len(node.names))[ci])
            else:
                dt = compute_dtype_of(ty)
                scale = 10 ** ty.scale if ty.name == "DECIMAL" else 1
                arr = np.asarray([
                    0 if v is None else
                    (int(round(float(v) * scale)) if scale != 1 else v)
                    for v in vals]).astype(dt)
                cols.append(arr)
                dicts.append(None)
            valids.append(None if mask.all() else mask)
        mat = Mat(list(node.names), list(node.types), dicts, cols, valids)
        return mat

    # ==================================================================
    # aggregation
    # ==================================================================

    def _exec_aggregate(self, node: b.LogicalAggregate, lits) -> Mat:
        child = node.child
        # fused scan-aggregate fast path
        if isinstance(child, b.LogicalGet):
            return self._aggregate_over_scan(node, child, lits)
        if isinstance(child, (b.LogicalJoin, b.LogicalProject)):
            mat = self._try_streaming_join_agg(node, child, lits)
            if mat is not None:
                return mat
        mat = self._exec(child, lits)
        return self._aggregate_host(node, mat, lits)

    def _try_streaming_join_agg(self, node: b.LogicalAggregate,
                                child, lits) -> Optional[Mat]:
        """Aggregate sink fused into a streamed LEFT-DEEP pipeline
        (reference pipeline_executor.cpp push loop: source -> operators
        -> sink in 2048-row chunks): the plan spine
        Aggregate <- [Project|Join]* <- Get streams the base table
        segment-by-segment; every join's build side materializes ONCE
        into a persistent native hash table, every Project re-applies
        per morsel, and morsels fold into partial group state with
        amortized merges — the joined intermediate (TPC-H Q18's
        lineitem x orders x customer) never materializes at once."""
        if not getattr(self.config, "streaming_agg_sink_enabled", True):
            return None
        if getattr(self.db, "mesh", None) is not None:
            return None
        from adacom import native as _native

        if not _native.available() or \
                not getattr(self.config, "streaming_join_enabled", True):
            return None
        specs, finishers = self._agg_specs(node)
        if any(d for *_x, d in specs):
            return None
        if any(k == "hll" or k.startswith("q:") for k, *_x in specs):
            return None
        # walk the left-deep spine down to a Get
        stages = []  # outermost first; applied reversed per morsel
        cur = child
        while len(stages) < 8:
            if isinstance(cur, b.LogicalProject):
                stages.append(("project", cur))
                cur = cur.child
            elif isinstance(cur, b.LogicalJoin):
                if (not cur.conditions or cur.join_type not in
                        ("inner", "semi", "anti", "left")):
                    return None
                if self._ij_eligible(cur, "right") or \
                        self._ij_eligible(cur, "left"):
                    return None  # index-join reductions beat streaming
                stages.append(("join", cur))
                cur = cur.left
            else:
                break
        if not isinstance(cur, b.LogicalGet) or \
                not any(k == "join" for k, _n in stages):
            return None
        get = cur

        # build every join stage's hash table (build sides materialize
        # once — the reference's per-pipeline sink dependency)
        built = {}  # id(join node) -> (right, rkeys, exact, ht)
        try:
            for kind, jn in stages:
                if kind != "join":
                    continue
                right = self._exec(jn.right, lits)
                got = self._build_join_ht(jn, right, lits)
                if got is None:
                    return None
                rkeys, exact, ht = got
                built[id(jn)] = (right, rkeys, exact, ht)

            fold = _StreamAggFold(self, node, lits, specs, finishers)
            ok = self._stream_pipeline(get, stages, built, fold, lits)
            if not ok:
                return None
            self.db.dist_stats["streamed_join_agg"] = \
                self.db.dist_stats.get("streamed_join_agg", 0) + 1
            return fold.finish()
        finally:
            for _r, _k, _e, ht in built.values():
                ht.close()

    def _stream_pipeline(self, get, stages, built, fold, lits) -> bool:
        """Drive the pipeline: scan morsels in parallel waves, apply the
        stage chain per morsel (workers), fold serially. Returns False to
        signal the caller to fall back (non-numpy filter/expr)."""
        from adacom.parallel.scheduler import TaskScheduler

        snap = self._pin_snapshot(get.table)
        filt = self._compiled_filter(get)
        params = filt.prep_args(lits) if filt is not None else ()
        candidates = self._zonemap_candidates(get, lits, snap)
        dicts_g = list(getattr(get, "dicts", [None] * len(get.names)))

        def run_morsel(i):
            mat = self._scan_chunk_host(get, snap, i, filt, params, dicts_g)
            for kind, n_ in reversed(stages):
                if mat.nrows == 0:
                    return mat
                if kind == "project":
                    mat = self._project_mat(n_, mat, lits)
                else:
                    mat = self._apply_probe_stage(n_, built[id(n_)], mat,
                                                  lits)
            return mat

        wave = max(4, (self.config.threads
                       or TaskScheduler.get().n_threads) * 4)
        try:
            for w0 in range(0, len(candidates), wave):
                results = TaskScheduler.get().map_segments(
                    run_morsel, candidates[w0:w0 + wave],
                    threads=self.config.threads)
                for mat in results:
                    fold.add(mat)
        except _FallbackToDevice:
            return False
        return True

    def _scan_chunk_host(self, get, snap, i, filt, params, dicts) -> Mat:
        """One filtered scan morsel as a host Mat (the pipeline source)."""
        segs = [snap.segment(c, i) for c in get.column_ids]
        cols = [(s.host_plain(), s.host_validity()) for s in segs]
        n = segs[0].count if segs else 0
        mask = None
        if filt is not None:
            try:
                fv, fm = filt.fn(cols, params)
            except Exception:
                raise _FallbackToDevice()
            if not isinstance(fv, np.ndarray):
                raise _FallbackToDevice()
            mask = fv if fm is None else (fv & fm)
        dm = snap.delete_mask(i)
        if dm is not None:
            dmx = np.zeros(n, dtype=bool)
            dmx[: min(len(dm), n)] = dm[:n]
            mask = ~dmx if mask is None else (mask & ~dmx)
        rows = np.nonzero(mask)[0] if mask is not None else None
        return Mat(
            list(get.names), list(get.types), dicts,
            [c[rows] if rows is not None else c for c, _v in cols],
            [None if v is None else (v[rows] if rows is not None else v)
             for _c, v in cols],
        )

    def _apply_probe_stage(self, jn, st, chunk: Mat, lits) -> Mat:
        """Probe one join stage's persistent hash table with a morsel."""
        right, rkeys, exact, ht = st
        jt = jn.join_type
        lkeys = []
        for le, _re in jn.conditions:
            (lv, lm), = self._eval_on_mat([le], chunk, lits)
            lk = np.asarray(lv)
            if not isinstance(lv, np.ndarray):
                raise _FallbackToDevice()
            if lm is not None:
                lk = np.where(np.asarray(lm), lk, _null_key(lk.dtype))
            lkeys.append(lk)
        lk64 = (np.ascontiguousarray(lkeys[0], dtype=np.int64) if exact
                else _row_keys(lkeys).view(np.int64))
        li, ri = ht.probe(lk64)
        if not exact and len(li):
            ok = np.ones(len(li), dtype=bool)
            for lcol, rcol in zip(lkeys, rkeys):
                ok &= lcol[li].astype(np.int64) == \
                    rcol[ri].astype(np.int64)
            li, ri = li[ok], ri[ok]
        if jn.residual is not None and len(li):
            # non-equi conjuncts evaluated per candidate pair (reference
            # physical_hash_join.cpp comparison+residual handling)
            ok = self._residual_mask(jn, chunk, right, li, ri, lits)
            li, ri = li[ok], ri[ok]
        dicts_j = list(getattr(jn, "dicts", [None] * len(jn.names)))
        if jt == "inner":
            left = chunk.take(li)
            rcols = [_gather_rows(c, ri) for c in right.cols]
            rvalids = [None if v is None else _gather_rows(v, ri)
                       for v in right.valids]
            return Mat(list(jn.names), list(jn.types), dicts_j,
                       left.cols + rcols, left.valids + rvalids)
        if jt == "left":
            # preserved side: unmatched rows append with NULL right
            # columns (same padding as the materializing join)
            matched = np.zeros(chunk.nrows, dtype=bool)
            matched[li] = True
            un = np.nonzero(~matched)[0]
            lcols = [np.concatenate([_gather_rows(c, li), c[un]])
                     for c in chunk.cols]
            lvalids = [None if v is None
                       else np.concatenate([v[li], v[un]])
                       for v in chunk.valids]
            rcols = [np.concatenate([_gather_rows(c, ri),
                                     np.zeros(len(un), c.dtype)])
                     for c in right.cols]
            rvalids = [np.concatenate([
                v[ri] if v is not None else np.ones(len(ri), bool),
                np.zeros(len(un), bool)]) for v in right.valids]
            return Mat(list(jn.names), list(jn.types), dicts_j,
                       lcols + rcols, lvalids + rvalids)
        matched = np.zeros(chunk.nrows, dtype=bool)
        matched[li] = True
        keep = np.nonzero(matched if jt == "semi" else ~matched)[0]
        out = chunk.take(keep)
        return Mat(list(jn.names), list(jn.types), dicts_j,
                   out.cols, out.valids)

    def _agg_specs(self, node: b.LogicalAggregate):
        """Flatten BoundAggregates into primitive partial specs.

        Returns (specs, finishers): specs = [(kind, arg_expr|None, acc_dtype,
        distinct)], finishers map primitive partial values -> final
        aggregate values."""
        specs: List[Tuple[str, Optional[b.BExpr], Any, bool]] = []
        finishers = []
        for a in node.aggregates:
            if a.func == "count_star":
                si = len(specs)
                specs.append(("count", None, np.int64, False))
                finishers.append(lambda p, si=si: p[si])
            elif a.func == "count":
                si = len(specs)
                specs.append(("count_arg", a.arg, np.int64, a.distinct))
                finishers.append(lambda p, si=si: p[si])
            elif a.func == "sum":
                acc = np.float64 if a.ty.is_float else np.int64
                si = len(specs)
                specs.append(("sum", a.arg, acc, a.distinct))
                ci = len(specs)
                specs.append(("count_arg", a.arg, np.int64, a.distinct))
                # grouped: groups with zero non-null args keep sum 0 (SQL
                # NULL-sum for all-null groups is a TODO with valid masks)
                finishers.append(
                    lambda p, si=si, ci=ci: p[si]
                    if isinstance(p[ci], np.ndarray) else (p[si] if p[ci] > 0 else None)
                )
            elif a.func == "avg":
                si = len(specs)
                specs.append(("sum", a.arg, np.float64, a.distinct))
                ci = len(specs)
                specs.append(("count_arg", a.arg, np.int64, a.distinct))
                scale = 10.0 ** a.arg.ty.scale if a.arg.ty.name == "DECIMAL" else 1.0

                def fin(p, si=si, ci=ci, scale=scale):
                    cnt = p[ci]
                    if isinstance(cnt, np.ndarray):
                        safe = np.where(cnt > 0, cnt, 1)
                        return np.where(cnt > 0, (p[si] / scale) / safe, np.nan)
                    return (p[si] / scale) / cnt if cnt > 0 else None
                finishers.append(fin)
            elif a.func in ("min", "max"):
                dt = compute_dtype_of(a.arg.ty)
                acc = np.float64 if np.dtype(dt).kind == "f" else np.int64
                si = len(specs)
                specs.append((a.func, a.arg, acc, False))
                ci = len(specs)
                specs.append(("count_arg", a.arg, np.int64, a.distinct))

                def fin(p, si=si, ci=ci):
                    cnt = p[ci]
                    if isinstance(cnt, np.ndarray):
                        return p[si]
                    return p[si] if cnt > 0 else None
                finishers.append(fin)
            elif a.func in ("stddev", "stddev_samp", "var_samp", "variance"):
                si = len(specs)
                specs.append(("sum", a.arg, np.float64, a.distinct))
                qi = len(specs)
                specs.append(("sumsq", a.arg, np.float64, a.distinct))
                ci = len(specs)
                specs.append(("count_arg", a.arg, np.int64, a.distinct))
                is_std = a.func in ("stddev", "stddev_samp")

                def fin(p, si=si, qi=qi, ci=ci, is_std=is_std):
                    n = p[ci]
                    if isinstance(n, np.ndarray):
                        safe = np.where(n > 1, n, 2)
                        var = (p[qi] - p[si] * p[si] / np.where(n > 0, n, 1)) / (safe - 1)
                        var = np.where(n > 1, var, np.nan)
                        return np.sqrt(var) if is_std else var
                    if n <= 1:
                        return None
                    var = (p[qi] - p[si] * p[si] / n) / (n - 1)
                    return float(np.sqrt(var)) if is_std else float(var)
                finishers.append(fin)
            elif a.func == "first":
                si = len(specs)
                specs.append(("min", a.arg, np.int64, False))  # deterministic pick
                finishers.append(lambda p, si=si: p[si])
            elif a.func == "approx_count_distinct":
                si = len(specs)
                specs.append(("hll", a.arg, np.int64, False))
                finishers.append(lambda p, si=si: p[si])
            elif a.func.startswith("quantile_"):
                interp, qs = a.func.split(":")
                interp = interp.rsplit("_", 1)[1]  # cont | disc
                si = len(specs)
                specs.append((f"q:{interp}:{qs}", a.arg, np.float64, False))
                # cont quantile of a DECIMAL arg unscales to a double
                scale = 10.0 ** a.arg.ty.scale if (
                    interp == "cont" and a.arg.ty.name == "DECIMAL") else 1.0

                def fin(p, si=si, scale=scale):
                    v = p[si]
                    if isinstance(v, np.ndarray):
                        return v / scale if scale != 1.0 else v
                    if v is None or (isinstance(v, float) and np.isnan(v)):
                        return None
                    return v / scale if scale != 1.0 else v
                finishers.append(fin)
            elif a.func in ("bool_and", "bool_or"):
                kind = "min" if a.func == "bool_and" else "max"
                si = len(specs)
                specs.append((kind, a.arg, np.int64, False))
                ci = len(specs)
                specs.append(("count_arg", a.arg, np.int64, False))

                def fin(p, si=si, ci=ci):
                    cnt = p[ci]
                    if isinstance(cnt, np.ndarray):
                        return (p[si] != 0).astype(np.uint32)
                    if cnt == 0:
                        return None
                    return 1 if p[si] != 0 else 0
                finishers.append(fin)
            else:
                raise ExecError(f"aggregate {a.func}")
        return specs, finishers

    def _group_domain(self, node: b.LogicalAggregate, get: Optional[b.LogicalGet]):
        """Dense-domain info for group keys, or None for host fallback."""
        if get is not None:
            # seal staged appends first: zonemap stats only cover segments
            # (unflushed staging made the domain collapse to one group)
            get.table.flush()
        mins, sizes = [], []
        for g in node.groups:
            if isinstance(g, b.BColumn) and g.dictionary is not None:
                mins.append(0)
                sizes.append(max(1, len(g.dictionary)))
                continue
            if g.ty.integer and get is not None and isinstance(g, b.BColumn):
                col = get.table.columns[get.column_ids[g.index]]
                if not col.segments:
                    mins.append(0)
                    sizes.append(1)
                    continue
                lo = min(s.vmin for s in col.segments)
                hi = max(s.vmax for s in col.segments)
                mins.append(int(lo))
                sizes.append(int(hi - lo + 1))
                continue
            if g.ty is tt.BOOLEAN:
                mins.append(0)
                sizes.append(2)
                continue
            return None
        domain = 1
        for s in sizes:
            domain *= s
        if domain > (1 << 22):
            return None
        strides = []
        acc = 1
        for s in reversed(sizes):
            strides.append(acc)
            acc *= s
        strides.reverse()
        return mins, strides, sizes, domain

    def _aggregate_over_scan(self, node, get: b.LogicalGet, lits) -> Mat:
        specs, finishers = self._agg_specs(node)
        grouped = bool(node.groups)
        dense = self._group_domain(node, get) if grouped else None
        holistic = any(k == "hll" or k.startswith("q:")
                       for k, *_x in specs)
        if not holistic and not any(d for *_x, d in specs) and \
                (not grouped or dense is not None):
            mat = self._try_fused_multi_agg(node, get, lits, specs,
                                            finishers, dense)
            if mat is not None:
                return mat
        if (grouped and dense is None) or any(d for *_x, d in specs) \
                or holistic:
            # non-dense domains, DISTINCT, and holistic aggregates
            # (quantile/HLL) take the host tier
            mat = self._materialize_scan(get, lits)
            return self._aggregate_host(node, mat, lits)
        if grouped and dense[3] > HOST_AGG_DOMAIN and \
                getattr(self.db, "mesh", None) is None and \
                jax.default_backend() != "cpu" and \
                get.table.row_count() < getattr(
                    self.config, "device_agg_min_rows", 32_000_000):
            # large dense domains below device_agg_min_rows rows take the
            # host hash aggregate on an accelerator (both thresholds were
            # inherited from TPC-H Q15 tuning, not yet measured on a GPU)
            mat = self._materialize_scan(get, lits)
            return self._aggregate_host(node, mat, lits)

        # compile group + agg arg expressions once
        comp = ExprCompiler()
        group_fns = [comp._c(g) for g in node.groups]
        arg_fns = {}
        for kind, arg, acc, _d in specs:
            if arg is not None and id(arg) not in arg_fns:
                arg_fns[id(arg)] = comp._c(arg)
        spec_entries = [
            (kind, None if arg is None else arg_fns[id(arg)], acc)
            for kind, arg, acc, _d in specs
        ]
        params = tuple(p(lits) for p in comp.preps)

        partials = None
        kernels = getattr(node, "_agg_kernels", None)
        if kernels is None:
            kernels = node._agg_kernels = {}
        for i, count, _key_unused in self._scan_agg_batches(
            node, get, lits, spec_entries, group_fns, dense, params, kernels
        ):
            batch = _key_unused
            if partials is None:
                partials = list(batch)
            else:
                partials = [
                    agg_ops.merge_partials(_merge_kind(spec_entries[k][0]), partials[k], batch[k])
                    for k in range(len(batch))
                ]
        if partials is None:
            partials = _init_empty_partials(spec_entries, dense)

        host = _pull_partials(partials)
        if not grouped:
            prim = [h.item() if h.ndim == 0 else h for h in host]
            out_vals = [f(prim) for f in finishers]
            cols, valids = _agg_finalize_row(node, out_vals)
            dicts = getattr(node, "dicts", [None] * len(node.names))
            return Mat(list(node.names), list(node.types), dicts, cols, valids)

        mins, strides, sizes, domain = dense
        count_idx = _any_count_index(spec_entries)
        present = host[count_idx] > 0 if count_idx is not None else np.ones(domain, bool)
        gidx = np.nonzero(present)[0]
        group_cols = []
        for gi, g in enumerate(node.groups):
            vals = (gidx // strides[gi]) % sizes[gi]
            group_cols.append(vals + mins[gi])
        prim = [h[gidx] for h in host]
        agg_cols = [f(prim) for f in finishers]
        cols = []
        valids: List[Optional[np.ndarray]] = []
        for gi, g in enumerate(node.groups):
            cols.append(group_cols[gi].astype(compute_dtype_of(g.ty)))
            valids.append(None)
        for a, v in zip(node.aggregates, agg_cols):
            arr = np.asarray(v)
            if a.func in ("min", "max", "first") and arr.dtype.kind in "iu":
                arr = arr.astype(compute_dtype_of(a.ty))
            elif a.func.startswith("quantile_disc") and \
                    np.dtype(compute_dtype_of(a.ty)).kind in "iu":
                arr = np.round(arr).astype(compute_dtype_of(a.ty))
            cols.append(arr)
            valids.append(None)
        dicts = getattr(node, "dicts", [None] * len(node.names))
        return Mat(list(node.names), list(node.types), dicts, cols, valids)

    def _try_fused_multi_agg(self, node, get: b.LogicalGet, lits,
                             specs, finishers, dense) -> Optional[Mat]:
        """Pallas (Triton) multi-plane multi-aggregate scan (TPC-H
        Q1-class, ops/gpu_scan.py): N SUM/COUNT aggregates whose arguments
        are polynomials over DECIMAL/integer scan columns
        (sum(price*(1-disc)*(1+tax)) expands to signed combinations of
        monomial sums), grouped by a small dense domain over up to several
        key columns, with conjunctive per-column range filters — all fused
        with the succinct decode of every referenced plane in ONE kernel
        pass (reference: perfect_aggregate_hashtable.cpp +
        expression_executor.cpp, collapsed into the scan). Runs where
        DBConfig.fused_scan_kernel allows; None -> the XLA path."""
        mode = self.config.fused_scan_kernel
        if mode == "off" or (mode == "gpu" and jax.default_backend() != "gpu"):
            return None
        if getattr(self.db, "mesh", None) is not None:
            return None
        from adacom.ops import gpu_scan

        grouped = bool(node.groups)
        if grouped:
            if dense is None:
                return None
            mins_d, strides, sizes, domain = dense
        else:
            mins_d, strides, sizes, domain = [], [], [], 1
        if not (1 <= domain <= gpu_scan.MAX_GROUPS):
            return None
        for g in node.groups:
            if not isinstance(g, b.BColumn):
                return None
        gcols = [g.index for g in node.groups]

        # ---- decompose aggregate args into monomial plans ----
        mono_ids: Dict[tuple, int] = {}
        spec_plans = []
        vcheck_cols = set()  # columns whose validity must be absent
        for kind, arg, acc, distinct in specs:
            if distinct:
                return None
            if kind == "count":
                spec_plans.append(None)
                continue
            if kind == "count_arg":
                if arg is None:
                    return None
                pd = _poly_decompose(arg, lits)
                if pd is None:
                    return None
                for m in pd[0]:
                    vcheck_cols.update(m)
                spec_plans.append(None)
                continue
            if kind != "sum":
                return None
            pd = _poly_decompose(arg, lits)
            if pd is None:
                return None
            terms, scale = pd
            declared = arg.ty.scale if arg.ty.name == "DECIMAL" else 0
            if scale != declared:
                return None
            plan = []
            for mono, coef in terms.items():
                if coef == 0:
                    continue
                if len(mono) > gpu_scan.MAX_MONO_DEGREE:
                    return None
                mi = (None if len(mono) == 0
                      else mono_ids.setdefault(mono, len(mono_ids)))
                plan.append((int(coef), mi))
                vcheck_cols.update(mono)
            spec_plans.append(plan)
        monos = [m for m, _i in sorted(mono_ids.items(), key=lambda kv: kv[1])]

        # ---- fold filters into per-column integer ranges ----
        ranges: Dict[int, list] = {}
        empty_all = False
        for f in get.filters:
            p = _zonemap_probe(f, lits)
            if p is None:
                return None
            ci, op, val = p
            r = ranges.setdefault(ci, [None, None])
            if op == "=":
                iv = int(np.floor(val))
                if np.longdouble(iv) != val:
                    empty_all = True
                else:
                    r[0] = iv if r[0] is None else max(r[0], iv)
                    r[1] = iv if r[1] is None else min(r[1], iv)
            elif op == "<":
                b_ = int(np.ceil(val)) - 1
                r[1] = b_ if r[1] is None else min(r[1], b_)
            elif op == "<=":
                b_ = int(np.floor(val))
                r[1] = b_ if r[1] is None else min(r[1], b_)
            elif op == ">":
                b_ = int(np.floor(val)) + 1
                r[0] = b_ if r[0] is None else max(r[0], b_)
            elif op == ">=":
                b_ = int(np.ceil(val))
                r[0] = b_ if r[0] is None else max(r[0], b_)
        for r in ranges.values():
            if r[0] is not None and r[1] is not None and r[0] > r[1]:
                empty_all = True
        if len(ranges) > 8:
            return None

        mono_cols = sorted({c for m in monos for c in m})
        plane_cols = sorted(set(mono_cols) | set(ranges))
        if not grouped and len(plane_cols) == 1:
            # one-column ungrouped scans: the XLA path is faster end to end
            # on the H100 (PERF.md)
            return None
        if not plane_cols and not gcols:
            # nothing to unpack (bare count(*)): the kernel would have no
            # word planes to derive the lane count from (a class of
            # all-constant/absent planes once mis-counted segments wider
            # than one lane tile); the host answers counts from metadata
            return None
        if len(plane_cols) > gpu_scan.MAX_PLANES or \
                len(gcols) > 6:
            return None
        plane_pos = {c: p for p, c in enumerate(plane_cols)}
        kmonos = tuple(tuple(plane_pos[c] for c in m) for m in monos)
        kpreds = tuple(plane_pos[c] for c in sorted(ranges))
        vcheck_only = sorted(vcheck_cols - set(plane_cols) - set(gcols))

        # plane types must be exact integers (scaled DECIMAL / int / date
        # / dict codes); floats can't ride the integer kernel
        for c in plane_cols + gcols:
            ty = get.types[c]
            if ty.is_float or (ty.is_string and c not in gcols):
                return None

        # ---- per-segment eligibility sweep + class pooling ----
        snap = self._pin_snapshot(get.table)
        candidates = self._zonemap_candidates(get, lits, snap)
        classes: Dict[tuple, list] = {}
        plane_vmax = [0] * len(plane_cols)
        for i in candidates:
            if snap.delete_mask(i) is not None:
                return None
            entry_planes = []
            for c in gcols + plane_cols + vcheck_only:
                s = snap.segment(get.column_ids[c], i)
                if s._validity_np is not None:
                    return None
                if c in vcheck_only and c not in plane_cols:
                    continue
                if not s.is_compacted() or s.codec not in (None, "succinct"):
                    return None
                meta, arrs = s.reader_arrays()
                if meta[0] != "packed":
                    return None
                widths, L, _dt = meta[1]
                if len(widths) > 1 and widths[1] != 0:
                    return None  # true 64-bit span: host tier
                w = widths[0]
                mf = s._packed.min_factor
                word = arrs[0] if w > 0 else None
                entry_planes.append((c, w, L, int(mf), int(s.vmax), word,
                                     id(s), s.version))
            key = tuple((c, w) for c, w, *_r in entry_planes)
            classes.setdefault(key, []).append(
                (i, snap.segment_rows(i), entry_planes))

        n_planes = len(plane_cols)
        n_group_planes = len(gcols)
        for entries in classes.values():
            for _i, _cnt, planes in entries:
                for pj, (c, w, L, mf, vmax, _wd, _id, _v) in enumerate(planes):
                    if pj < n_group_planes:
                        gj = pj
                        if mf - (mins_d[gj] if grouped else 0) < 0:
                            return None
                    else:
                        p = pj - n_group_planes
                        if c in mono_cols and (mf < 0 or vmax >= (1 << 31)):
                            return None
                        plane_vmax[p] = max(plane_vmax[p], vmax)
        # per-row monomial products stay below 2^32, so the kernel's int64
        # per-lane sums cannot overflow
        for m in monos:
            prod = 1
            for c in m:
                prod *= max(1, plane_vmax[plane_pos[c]])
            if prod >= (1 << 32):
                return None

        kstrides = tuple(int(s) for s in strides) if grouped else ()
        sums = np.zeros((domain, len(monos)), np.int64)
        cnts = np.zeros(domain, np.int64)
        if not empty_all:
            cache = getattr(get.table, "_pool_cache", None)
            if cache is None:
                cache = get.table._pool_cache = {}
            for ckey, entries in classes.items():
                if not any(w > 0 for _c, w in ckey):
                    # all-constant planes: no words to size the lane grid
                    return None
                scal = np.zeros((len(entries), 32), np.int64)
                seg_sig = []
                for ei, (i, cnt_i, planes) in enumerate(entries):
                    scal[ei, gpu_scan.SC_COUNT] = cnt_i
                    scal[ei, gpu_scan.SC_LANES] = bitpack.lanes_for(cnt_i)
                    for pj, (c, w, L, mf, vmax, _wd, sid, sver) in \
                            enumerate(planes):
                        seg_sig.append((sid, sver))
                        if pj < n_group_planes:
                            scal[ei, gpu_scan.SC_GMIN + pj] = \
                                mf - (mins_d[pj] if grouped else 0)
                            continue
                        p = pj - n_group_planes
                        scal[ei, gpu_scan.SC_VMIN + p] = mf
                        rr = ranges.get(c)
                        if rr is not None:
                            q = kpreds.index(p)
                            scal[ei, gpu_scan.SC_LO + q] = \
                                -(1 << 62) if rr[0] is None else rr[0]
                            scal[ei, gpu_scan.SC_HI + q] = \
                                (1 << 62) if rr[1] is None else rr[1]
                stack_key = ("multi", ckey, tuple(seg_sig))
                stacked = cache.get(stack_key)
                if stacked is None:
                    L_pad = max(L for _i2, _c2, planes in entries
                                for _c3, w, L, *_r3 in planes if w > 0)
                    L_pad = -(-L_pad // 32) * 32

                    def padw(words):
                        if words.shape[1] == L_pad:
                            return words
                        return jnp.pad(
                            words, ((0, 0), (0, L_pad - words.shape[1])))
                    gstacks, vstacks = [], []
                    for pj in range(len(entries[0][2])):
                        w = entries[0][2][pj][1]
                        if w == 0:
                            stackp = None
                        else:
                            stackp = jnp.stack(
                                [padw(e[2][pj][5]) for e in entries])
                        if pj < n_group_planes:
                            gstacks.append(stackp)
                        else:
                            vstacks.append(stackp)
                    stacked = (gstacks, vstacks)
                    if len(cache) > 8:
                        cache.clear()
                    cache[stack_key] = stacked
                gstacks, vstacks = stacked
                dev_out = gpu_scan.multi_scan(
                    gstacks, vstacks, jnp.asarray(scal), domain, kstrides,
                    kmonos, kpreds, interpret=mode == "interpret")
                self._count_device_agg((dev_out,))
                out = np.asarray(dev_out)
                sums += out[:, :len(monos)]
                cnts += out[:, len(monos)]

        # ---- finish ----
        def spec_prim(plan, gsel):
            if plan is None:
                return cnts[gsel]
            acc = np.zeros_like(cnts[gsel])
            for coef, mi in plan:
                acc = acc + coef * (cnts[gsel] if mi is None
                                    else sums[gsel, mi])
            return acc

        self.db.dist_stats["fused_multi_agg"] = \
            self.db.dist_stats.get("fused_multi_agg", 0) + 1
        if not grouped:
            prim = []
            for plan in spec_plans:
                v = spec_prim(plan, slice(None))
                prim.append(int(v[0]))
            out_vals = [f(prim) for f in finishers]
            cols, valids = _agg_finalize_row(node, out_vals)
            dicts = getattr(node, "dicts", [None] * len(node.names))
            return Mat(list(node.names), list(node.types), dicts, cols,
                       valids)
        present = cnts > 0
        gidx = np.nonzero(present)[0]
        prim = [spec_prim(plan, gidx) for plan in spec_plans]
        agg_cols = [f(prim) for f in finishers]
        cols = []
        valids = []
        for gi, g in enumerate(node.groups):
            vals = (gidx // strides[gi]) % sizes[gi] + mins_d[gi]
            cols.append(vals.astype(compute_dtype_of(g.ty)))
            valids.append(None)
        for a, v in zip(node.aggregates, agg_cols):
            cols.append(np.asarray(v))
            valids.append(None)
        dicts = getattr(node, "dicts", [None] * len(node.names))
        return Mat(list(node.names), list(node.types), dicts, cols, valids)

    def _scan_agg_batches(self, node, get, lits, spec_entries, group_fns,
                          dense, params, kernels):
        """Run the fused scan+aggregate kernel over candidate segments.

        Segments with the same representation meta are *pooled*: their
        packed arrays stack into one (n_seg, ...) batch and a single
        vmapped kernel produces the merged partials — one dispatch per
        representation class instead of one per segment (the reference's
        morsel loop, amortized; pool stacks are cached across queries)."""
        table = get.table
        snap = self._pin_snapshot(table)
        filt = self._compiled_filter(get)
        fparams = filt.prep_args(lits) if filt is not None else ()
        per_segment = []
        pools: Dict[tuple, list] = {}
        for i in self._zonemap_candidates(get, lits, snap):
            segs = [snap.segment(c, i) for c in get.column_ids]
            count = segs[0].count if segs else 0
            metas, arrays = [], []
            for s in segs:
                meta, arrs = s.reader_arrays()
                vmeta = s.validity_arrays()
                if vmeta is not None:
                    meta = (meta, "v")
                    arrs = arrs + vmeta
                else:
                    meta = (meta, None)
                metas.append(meta)
                arrays.extend(arrs)
            del_mask = snap.delete_mask(i)
            has_del = del_mask is not None
            n_pad = bitpack.ROWS * bitpack.lanes_for(count)
            key = (tuple(metas), n_pad, has_del)
            if has_del:
                per_segment.append((i, count, key, metas, arrays, del_mask))
            else:
                pools.setdefault(key, []).append(
                    (i, count, segs, arrays)
                )

        mesh = getattr(self.db, "mesh", None)
        n_dev = mesh.devices.size if mesh is not None else 0
        for key, entries in pools.items():
            metas_t, n_pad, _ = key
            if len(entries) < (1 if mesh is not None else 4):
                for i, count, segs, arrays in entries:
                    per_segment.append((i, count, key, list(metas_t), arrays, None))
                continue
            # pooled path: pad the pool to the next power of two with
            # zero-count dummies so kernel shapes stay stable across
            # zonemap-dependent candidate sets (mesh mode: also to a
            # multiple of the device count for even sharding)
            n = len(entries)
            n_padded = 1 << (n - 1).bit_length()
            if mesh is not None:
                n_padded = max(n_padded, n_dev)
                if n_padded % n_dev:
                    n_padded = ((n_padded + n_dev - 1) // n_dev) * n_dev
            stack_key = (
                key, tuple(get.column_ids),
                tuple((id(s), s.version) for _, _, segs, _ in entries for s in segs),
                n_padded, n_dev,
            )
            cache = getattr(get.table, "_pool_cache", None)
            if cache is None:
                cache = get.table._pool_cache = {}
            stacked = cache.get(stack_key)
            if stacked is None:
                n_args = len(entries[0][3])
                cols_stacked = []
                for a in range(n_args):
                    arrs = [e[3][a] for e in entries]
                    pad = [arrs[-1]] * (n_padded - n)
                    cols_stacked.append(jnp.stack(arrs + pad))
                counts = np.zeros(n_padded, np.int32)
                counts[:n] = [e[1] for e in entries]
                counts = jnp.asarray(counts)
                if mesh is not None:
                    from adacom.parallel import mesh as pmesh

                    cols_stacked = [pmesh.shard_leading(mesh, a)
                                    for a in cols_stacked]
                    counts = pmesh.shard_leading(mesh, counts)
                stacked = (tuple(cols_stacked), counts)
                cache.clear() if len(cache) > 8 else None
                cache[stack_key] = stacked
            pkern_key = ("pool", key, n_padded, n_dev)
            kern = kernels.get(pkern_key)
            if kern is None:
                if mesh is not None:
                    kern = _build_distributed_scan_agg_kernel(
                        mesh, metas_t,
                        [compute_dtype_of(t) for t in get.types],
                        filt, n_pad, spec_entries, group_fns, dense,
                        n_arrays=len(entries[0][3]),
                    )
                else:
                    kern = _build_pooled_scan_agg_kernel(
                        metas_t,
                        [compute_dtype_of(t) for t in get.types],
                        filt, n_pad, spec_entries, group_fns, dense,
                    )
                kernels[pkern_key] = kern
            arrays_s, counts_s = stacked
            if mesh is not None:
                self.db.dist_stats["scan_agg"] += 1
            out = kern(counts_s, fparams, params, *arrays_s)
            self._count_device_agg(out)
            yield -1, sum(e[1] for e in entries), out

        for i, count, key, metas, arrays, del_mask in per_segment:
            metas_t, n_pad, has_del = key
            kern = kernels.get(key)
            if kern is None:
                kern = _build_scan_agg_kernel(
                    tuple(metas),
                    [compute_dtype_of(t) for t in get.types],
                    filt, n_pad, has_del, spec_entries, group_fns, dense,
                )
                kernels[key] = kern
            extra = []
            if has_del:
                dm = np.zeros(n_pad, dtype=bool)
                dm[: len(del_mask)] = del_mask
                extra.append(jnp.asarray(dm))
            out = kern(np.int32(count), fparams, params, tuple(extra), *arrays)
            self._count_device_agg(out)
            yield i, count, out

    def _count_device_agg(self, out) -> None:
        """Count a device scan-aggregate launch, per platform of the
        devices holding its partials (device_scan_agg_<platform>)."""
        stats = self.db.dist_stats
        stats["device_scan_agg"] = stats.get("device_scan_agg", 0) + 1
        for d in out[0].devices():
            key = f"device_scan_agg_{d.platform}"
            stats[key] = stats.get(key, 0) + 1

    def _aggregate_host(self, node: b.LogicalAggregate, mat: Mat, lits) -> Mat:
        """Host hash aggregate over a materialized batch (large domains,
        non-scan children)."""
        specs, finishers = self._agg_specs(node)
        uniq, prim = self._agg_partials(node, mat, lits, specs)
        return self._finish_agg(node, specs, finishers, uniq, prim)

    def _agg_partials(self, node: b.LogicalAggregate, mat: Mat, lits,
                      specs):
        """Group keys + primitive partial arrays for one batch — the
        local (per-morsel) half of the reference's local->global sink
        merge (partitionable_hashtable.cpp). Returns (uniq_key_arrays,
        prim_arrays); ungrouped batches return ([], [len-1 arrays])."""
        n = mat.nrows
        # evaluate group exprs + agg args (deduped by identity, matching the
        # consumption order below)
        arg_exprs = []
        seen_ids = set()
        for _, a, _, _d in specs:
            if a is not None and id(a) not in seen_ids:
                seen_ids.add(id(a))
                arg_exprs.append(a)
        exprs = list(node.groups) + arg_exprs
        outs = self._eval_on_mat(exprs, mat, lits) if exprs else []
        gvals = []
        for k in range(len(node.groups)):
            v, m = outs[k]
            arr = np.asarray(v)
            if arr.ndim == 0:
                arr = np.full(n, arr)
            gvals.append((arr, None if m is None else np.asarray(m)))
        arg_map = {}
        k = len(node.groups)
        for kind, a, acc, _d in specs:
            if a is not None and id(a) not in arg_map:
                v, m = outs[k]
                arr = np.asarray(v)
                if arr.ndim == 0:
                    arr = np.full(n, arr)
                arg_map[id(a)] = (arr, None if m is None else np.asarray(m))
                k += 1

        if node.groups:
            key_arrays = [g[0] for g in gvals]
            uniq, gid = _unique_rows(key_arrays)
            n_groups = len(uniq[0]) if uniq else 0
        else:
            gid = np.zeros(n, dtype=np.int64)
            uniq = []
            n_groups = 1

        prim = []
        for kind, a, acc, distinct in specs:
            if kind == "count":
                prim.append(np.bincount(gid, minlength=n_groups).astype(np.int64))
                continue
            vals, valid = arg_map[id(a)] if a is not None else (None, None)
            if distinct and kind in ("count_arg", "sum", "sumsq"):
                # keep only the first occurrence of each (group, value) pair
                first = np.zeros(n, dtype=bool)
                first[_unique_row_indices([gid, vals])] = True
                valid = first if valid is None else (first & valid)
            if kind == "count_arg":
                w = np.ones(n) if valid is None else valid.astype(np.float64)
                prim.append(np.bincount(gid, weights=w, minlength=n_groups).astype(np.int64))
            elif kind in ("sum", "sumsq"):
                v = vals.astype(acc)
                if kind == "sumsq":
                    v = v * v
                if valid is not None:
                    v = np.where(valid, v, 0)
                if np.dtype(acc) in (np.dtype(np.int64), np.dtype(np.float64)):
                    from adacom import native as _native

                    out = _native.group_sum(gid, v, n_groups).astype(acc)
                else:
                    out = np.zeros(n_groups, dtype=acc)
                    np.add.at(out, gid, v)
                prim.append(out)
            elif kind in ("min", "max"):
                v = vals.astype(acc)
                sent = (agg_ops._max_sentinel(acc) if kind == "min"
                        else agg_ops._min_sentinel(acc))
                if valid is not None:
                    v = np.where(valid, v, sent)
                out = np.full(n_groups, sent, dtype=acc)
                ufunc = np.minimum if kind == "min" else np.maximum
                ufunc.at(out, gid, v)
                prim.append(out)
            elif kind == "hll":
                prim.append(_hll_count(gid, vals, valid, n_groups))
            elif kind.startswith("q:"):
                _q, interp, qs = kind.split(":")
                prim.append(_group_quantile(gid, vals, valid, n_groups,
                                            float(qs), interp))
            else:
                raise ExecError(kind)
        return uniq, prim

    def _combine_partials(self, node, specs, keys_parts, prims_parts):
        """Merge per-morsel partials into one (uniq, prim) — the global
        half of the local->global sink merge. Mergeable kinds only
        (count/sum/sumsq/min/max); callers gate out distinct/holistic."""
        ng = len(node.groups)
        if ng == 0:
            prim = []
            for si, (kind, _a, acc, _d) in enumerate(specs):
                vals = np.asarray([pp[si][0] for pp in prims_parts])
                if kind == "min":
                    merged = vals.min()
                elif kind == "max":
                    merged = vals.max()
                else:
                    merged = vals.sum()
                prim.append(np.asarray([merged]))
            return [], prim
        keys = [np.concatenate([kp[g] for kp in keys_parts])
                for g in range(ng)]
        uniq, gid = _unique_rows(keys)
        n_groups = len(uniq[0]) if uniq else 0
        prim = []
        for si, (kind, _a, acc, _d) in enumerate(specs):
            v = np.concatenate([pp[si] for pp in prims_parts])
            if kind in ("min", "max"):
                sent = (agg_ops._max_sentinel(v.dtype) if kind == "min"
                        else agg_ops._min_sentinel(v.dtype))
                out = np.full(n_groups, sent, dtype=v.dtype)
                ufunc = np.minimum if kind == "min" else np.maximum
                ufunc.at(out, gid, v)
            elif v.dtype in (np.dtype(np.int64), np.dtype(np.float64)):
                from adacom import native as _native

                out = _native.group_sum(gid, v, n_groups).astype(v.dtype)
            else:
                out = np.zeros(n_groups, dtype=v.dtype)
                np.add.at(out, gid, v)
            prim.append(out)
        return uniq, prim

    def _finish_agg(self, node, specs, finishers, uniq, prim) -> Mat:
        if not node.groups:
            scal = [p[0] if isinstance(p, np.ndarray) else p for p in prim]
            out_vals = [f(scal) for f in finishers]
            cols, valids = _agg_finalize_row(node, out_vals)
            dicts = getattr(node, "dicts", [None] * len(node.names))
            return Mat(list(node.names), list(node.types), dicts, cols, valids)

        agg_cols = [f(prim) for f in finishers]
        cols = list(uniq)
        valids: List[Optional[np.ndarray]] = [None] * len(node.groups)
        for a, v in zip(node.aggregates, agg_cols):
            arr = np.asarray(v)
            if a.func in ("min", "max", "first") and arr.dtype.kind in "iu":
                arr = arr.astype(compute_dtype_of(a.ty))
            elif a.func.startswith("quantile_disc") and \
                    np.dtype(compute_dtype_of(a.ty)).kind in "iu":
                arr = np.round(arr).astype(compute_dtype_of(a.ty))
            cols.append(arr)
            valids.append(None)
        dicts = getattr(node, "dicts", [None] * len(node.names))
        return Mat(list(node.names), list(node.types), dicts, cols, valids)

    # ==================================================================
    # joins (vectorized host hash join)
    # ==================================================================

    def _exec_join(self, node: b.LogicalJoin, lits) -> Mat:
        left = right = None
        if node.conditions:
            # index join: probe the indexed base table with the other
            # side's keys instead of scanning it (whichever side the
            # build-side swap left it on)
            if self._ij_eligible(node, "right"):
                left = self._exec(node.left, lits)
                right = self._index_join_reduce(node, left, "right", lits)
            elif node.join_type == "inner" and \
                    self._ij_eligible(node, "left"):
                right = self._exec(node.right, lits)
                left = self._index_join_reduce(node, right, "left", lits)
        if left is None and node.conditions and node.residual is None and \
                node.join_type in ("inner", "semi", "anti") and \
                isinstance(node.left, b.LogicalGet):
            # morsel-streaming probe pipeline (reference PipelineExecutor:
            # source -> operators -> sink in chunks): build once from the
            # right side, stream the left base table segment-by-segment
            if right is None:
                right = self._exec(node.right, lits)
            mat = self._exec_join_streaming(node, right, lits)
            if mat is not None:
                return mat
        if left is None:
            left = self._exec(node.left, lits)
        if right is None:
            right = self._exec(node.right, lits)
        jt = node.join_type

        if jt in ("semi", "anti"):
            lkeys, rkeys = [], []
            for le, re_ in node.conditions:
                (lv, lm), = self._eval_on_mat([le], left, lits)
                (rv, rm), = self._eval_on_mat([re_], right, lits)
                lk, rk = np.asarray(lv), np.asarray(rv)
                if lm is not None:
                    lk = np.where(np.asarray(lm), lk, _null_key(lk.dtype))
                if rm is not None:
                    rk = np.where(np.asarray(rm), rk, _null_key(rk.dtype))
                lkeys.append(lk)
                rkeys.append(rk)
            li, ri = _hash_join_pairs(lkeys, rkeys, self.config, self.db)
            if node.residual is not None:
                # a left row matches iff SOME key-equal right row also passes
                # the residual (decorrelated EXISTS with non-equi conjuncts)
                ok = self._residual_mask(node, left, right, li, ri, lits)
                li = li[ok]
            matched = np.zeros(left.nrows, dtype=bool)
            matched[li] = True
            keep = np.nonzero(matched if jt == "semi" else ~matched)[0]
            out = left.take(keep)
            out.names = list(node.names)
            return out

        if not node.conditions:
            # cross product (also inner joins whose only predicates are
            # non-equi residuals)
            li = np.repeat(np.arange(left.nrows), right.nrows)
            ri = np.tile(np.arange(right.nrows), left.nrows)
        else:
            lkeys, rkeys = [], []
            for le, re_ in node.conditions:
                (lv, lm), = self._eval_on_mat([le], left, lits)
                (rv, rm), = self._eval_on_mat([re_], right, lits)
                lk = np.asarray(lv)
                rk = np.asarray(rv)
                # NULL keys never match
                if lm is not None:
                    lk = np.where(np.asarray(lm), lk, _null_key(lk.dtype))
                if rm is not None:
                    rk = np.where(np.asarray(rm), rk, _null_key(rk.dtype))
                lkeys.append(lk)
                rkeys.append(rk)
            li, ri = _hash_join_pairs(lkeys, rkeys, self.config, self.db)

        if node.residual is not None:
            # apply the residual to the matched pairs BEFORE computing the
            # preserved (unmatched) rows: a LEFT JOIN .. ON k AND p keeps
            # left rows whose matches all fail p, with NULL right columns
            # (reference: comparison-+-residual handling in
            # src/execution/operator/join/physical_hash_join.cpp)
            ok = self._residual_mask(node, left, right, li, ri, lits)
            li, ri = li[ok], ri[ok]

        if jt in ("left", "full"):
            matched = np.zeros(left.nrows, dtype=bool)
            matched[li] = True
            un = np.nonzero(~matched)[0]
        if jt in ("right", "full"):
            rmatched = np.zeros(right.nrows, dtype=bool)
            rmatched[ri] = True
            run = np.nonzero(~rmatched)[0]

        if isinstance(li, np.memmap):
            # spilled join: materialize output columns chunk-wise into
            # disk-backed arrays (outer-join padding below falls back to
            # RAM concatenation; the spill targets are inner joins)
            from adacom.exec import spill

            lcols = [spill.gather(c, li) for c in left.cols]
            lvalids = [None if v is None else spill.gather(v, li)
                       for v in left.valids]
            rcols = [spill.gather(c, ri) for c in right.cols]
            rvalids = [None if v is None else spill.gather(v, ri)
                       for v in right.valids]
        else:
            lcols = [_gather_rows(c, li) for c in left.cols]
            lvalids = [None if v is None else _gather_rows(v, li)
                       for v in left.valids]
            rcols = [_gather_rows(c, ri) for c in right.cols]
            rvalids = [None if v is None else _gather_rows(v, ri)
                       for v in right.valids]

        if jt in ("left", "full") and len(un):
            lcols = [np.concatenate([c, full_c[un]]) for c, full_c in zip(lcols, left.cols)]
            lvalids = [
                None if v is None and fv is None else
                np.concatenate([
                    v if v is not None else np.ones(len(li), bool),
                    fv[un] if fv is not None else np.ones(len(un), bool),
                ])
                for v, fv in zip(lvalids, left.valids)
            ]
            rcols = [np.concatenate([c, np.zeros(len(un), c.dtype)]) for c in rcols]
            rvalids = [
                np.concatenate([
                    v if v is not None else np.ones(len(ri), bool),
                    np.zeros(len(un), bool),
                ])
                for v in rvalids
            ]
        if jt in ("right", "full") and len(run):
            n_have = len(lcols[0]) if lcols else 0
            lcols = [np.concatenate([c, np.zeros(len(run), c.dtype)]) for c in lcols]
            lvalids = [
                np.concatenate([
                    v if v is not None else np.ones(n_have, bool),
                    np.zeros(len(run), bool),
                ])
                for v in lvalids
            ]
            rcols = [np.concatenate([c, full_c[run]]) for c, full_c in zip(rcols, right.cols)]
            rvalids = [
                None if v is None and fv is None else
                np.concatenate([
                    v if v is not None else np.ones(n_have, bool),
                    fv[run] if fv is not None else np.ones(len(run), bool),
                ])
                for v, fv in zip(rvalids, right.valids)
            ]

        return Mat(
            list(node.names), list(node.types),
            getattr(node, "dicts", [None] * len(node.names)),
            lcols + rcols, lvalids + rvalids,
        )

    def _streaming_join_eligible(self, node: b.LogicalJoin) -> bool:
        """Cheap static gates for the streamed probe pipeline (callers
        that pre-execute the build side check these first)."""
        from adacom import native as _native

        return bool(
            getattr(self.config, "streaming_join_enabled", True)
            and getattr(self.db, "mesh", None) is None
            and _native.available()
            and node.conditions and node.residual is None
            and node.join_type in ("inner", "semi", "anti")
            and isinstance(node.left, b.LogicalGet))

    def _build_join_ht(self, node: b.LogicalJoin, right: Mat, lits):
        """Build-side keys + persistent native hash table for a streamed
        probe; returns (rkeys, exact, ht) or None (budget / native)."""
        from adacom import native as _native

        rkeys = []
        for _le, re_ in node.conditions:
            (rv, rm), = self._eval_on_mat([re_], right, lits)
            rk = np.asarray(rv)
            if rm is not None:
                rk = np.where(np.asarray(rm), rk, _null_key(rk.dtype))
            rkeys.append(rk)
        budget = getattr(self.config, "memory_limit", None)
        if budget and len(rkeys[0]) * 24 > budget // 2:
            return None  # beyond budget: grace-hash spill path
        exact = (len(rkeys) == 1 and rkeys[0].dtype.kind in "iu"
                 and rkeys[0].dtype != np.uint64)
        rk64 = (np.ascontiguousarray(rkeys[0], dtype=np.int64) if exact
                else _row_keys(rkeys).view(np.int64))
        try:
            ht = _native.JoinTable(rk64)
        except RuntimeError:
            return None
        return rkeys, exact, ht

    def _exec_join_streaming(self, node: b.LogicalJoin, right: Mat,
                             lits) -> Optional[Mat]:
        """Pipelined hash-join probe (reference pipeline_executor.cpp:38
        push loop + JoinHashTable::Probe): the build side materialized
        once into a persistent native hash table, the probe side streamed
        morsel-by-morsel (one segment per task on the worker pool) — the
        probe table's full column set is never materialized at once.
        Inner/semi/anti without residuals; returns None to fall back."""
        if not getattr(self.config, "streaming_join_enabled", True):
            return None
        if getattr(self.db, "mesh", None) is not None:
            return None  # mesh mode: large joins shuffle over all_to_all
        from adacom import native as _native

        if not _native.available():
            return None
        get = node.left
        jt = node.join_type
        table = get.table
        snap = self._pin_snapshot(table)
        built = self._build_join_ht(node, right, lits)
        if built is None:
            return None
        rkeys, exact, ht = built
        filt = self._compiled_filter(get)
        params = filt.prep_args(lits) if filt is not None else ()
        candidates = self._zonemap_candidates(get, lits, snap)
        lexprs = [le for le, _re in node.conditions]
        dicts = getattr(get, "dicts", [None] * len(get.names))

        def probe_morsel(i):
            chunk = self._scan_chunk_host(get, snap, i, filt, params,
                                          list(dicts))
            lkeys = []
            for le in lexprs:
                (lv, lm), = self._eval_on_mat([le], chunk, lits)
                lk = np.asarray(lv)
                if lm is not None:
                    lk = np.where(np.asarray(lm), lk, _null_key(lk.dtype))
                lkeys.append(lk)
            lk64 = (np.ascontiguousarray(lkeys[0], dtype=np.int64) if exact
                    else _row_keys(lkeys).view(np.int64))
            li, ri = ht.probe(lk64)
            if not exact and len(li):
                ok = np.ones(len(li), dtype=bool)
                for lcol, rcol in zip(lkeys, rkeys):
                    ok &= lcol[li].astype(np.int64) == \
                        rcol[ri].astype(np.int64)
                li, ri = li[ok], ri[ok]
            if jt == "inner":
                out = chunk.take(li)
                return out, ri
            matched = np.zeros(chunk.nrows, dtype=bool)
            matched[li] = True
            keep = np.nonzero(matched if jt == "semi" else ~matched)[0]
            return chunk.take(keep), None

        from adacom.parallel.scheduler import TaskScheduler

        try:
            results = TaskScheduler.get().map_segments(
                probe_morsel, candidates, threads=self.config.threads)
        except _FallbackToDevice:
            ht.close()
            return None
        finally:
            ht.close()
        self.db.dist_stats["streamed_join"] = \
            self.db.dist_stats.get("streamed_join", 0) + 1
        lmats = [m for m, _ri in results]
        lcols = [
            np.concatenate([m.cols[ci] for m in lmats]) if lmats else
            np.empty(0, compute_dtype_of(get.types[ci]))
            for ci in range(len(get.names))
        ]
        lvalids: List[Optional[np.ndarray]] = []
        for ci in range(len(get.names)):
            if any(m.valids[ci] is not None for m in lmats):
                lvalids.append(np.concatenate([
                    m.valids[ci] if m.valids[ci] is not None
                    else np.ones(m.nrows, bool) for m in lmats]))
            else:
                lvalids.append(None)
        if jt in ("semi", "anti"):
            out = Mat(list(node.names), list(node.types),
                      list(getattr(node, "dicts", [None] * len(node.names))),
                      lcols, lvalids)
            return out
        ri_all = (np.concatenate([ri for _m, ri in results])
                  if results else np.zeros(0, np.int64))
        rcols = [_gather_rows(c, ri_all) for c in right.cols]
        rvalids = [None if v is None else _gather_rows(v, ri_all)
                   for v in right.valids]
        return Mat(
            list(node.names), list(node.types),
            list(getattr(node, "dicts", [None] * len(node.names))),
            lcols + rcols, lvalids + rvalids,
        )

    def _ij_eligible(self, node: b.LogicalJoin, side: str) -> bool:
        """Static index-join eligibility for `side` (reduced without row
        counts — those are checked in _index_join_reduce)."""
        if not getattr(self.config, "index_join_max_probe", 0):
            return False
        if side == "left" and node.join_type != "inner":
            return False  # reducing the preserved side needs bookkeeping
        if side == "right" and node.join_type not in ("inner", "semi"):
            return False
        get = node.right if side == "right" else node.left
        if not isinstance(get, b.LogicalGet) or get.filters:
            return False
        cols = []
        for le, re_ in node.conditions:
            key = re_ if side == "right" else le
            if not isinstance(key, b.BColumn):
                return False
            cols.append(get.column_ids[key.index])
        return get.table.index_on_columns(cols) is not None

    def _index_join_reduce(self, node: b.LogicalJoin, probe_mat: Mat,
                           side: str, lits) -> Optional[Mat]:
        """Index join (reference physical_index_join.cpp / plan_index_join):
        look the probe side's join keys up in the other side's index and
        materialize ONLY matching rows — the indexed table is never
        scanned. Returns the reduced Mat for `side`, or None (caller
        falls back to the full scan). The reduced side then rides the
        normal pair-expansion join, so duplicates and residuals keep
        their semantics."""
        get = node.right if side == "right" else node.left
        limit = getattr(self.config, "index_join_max_probe", 8192)
        if probe_mat.nrows > limit or probe_mat.nrows == 0:
            return None
        if get.table.row_count() < 4 * probe_mat.nrows:
            return None
        cols = []
        for le, re_ in node.conditions:
            key = re_ if side == "right" else le
            cols.append(get.column_ids[key.index])
        idx = get.table.index_on_columns(cols)
        if idx is None:
            return None
        probes = []
        for le, re_ in node.conditions:
            pe = le if side == "right" else re_
            (lv, lm), = self._eval_on_mat([pe], probe_mat, lits)
            lv = np.asarray(lv)
            if lm is not None:
                lv = np.where(np.asarray(lm), lv, _null_key(lv.dtype))
            probes.append(lv)
        snap = self._pin_snapshot(get.table)
        hits = idx.lookup_eq_batch(probes if idx.composite else probes[0])
        seg_rows = []
        arrays: List[List[np.ndarray]] = [[] for _ in get.column_ids]
        valids: List[List[Optional[np.ndarray]]] = [[] for _ in get.column_ids]
        any_valid = [False] * len(get.column_ids)
        n_vis = snap.segment_count()
        for seg_idx, rows in hits:
            if seg_idx >= n_vis:
                continue  # index saw segments sealed after the snapshot
            dm = snap.delete_mask(seg_idx)
            if dm is not None:
                inb = rows < len(dm)
                keep = np.ones(len(rows), dtype=bool)
                keep[inb] = ~dm[rows[inb]]
                rows = rows[keep]
            for ci, cname in enumerate(get.column_ids):
                seg = snap.segment(cname, seg_idx)
                hv = seg.host_plain()
                arrays[ci].append(hv[rows])
                v = seg.host_validity()
                if v is not None:
                    any_valid[ci] = True
                valids[ci].append(None if v is None else v[rows])
            seg_rows.append(len(rows))
        cols_np = [
            np.concatenate(a) if a else
            np.empty(0, compute_dtype_of(get.types[ci]))
            for ci, a in enumerate(arrays)
        ]
        valids_np: List[Optional[np.ndarray]] = []
        for ci in range(len(get.column_ids)):
            if not any_valid[ci]:
                valids_np.append(None)
            else:
                valids_np.append(np.concatenate([
                    v if v is not None else np.ones(n, bool)
                    for v, n in zip(valids[ci], seg_rows)
                ]))
        dicts = getattr(get, "dicts", [None] * len(get.names))
        self.db.dist_stats["index_join"] = \
            self.db.dist_stats.get("index_join", 0) + 1
        return Mat(list(get.names), list(get.types), list(dicts),
                   cols_np, valids_np)

    def _residual_mask(self, node, left: Mat, right: Mat, li, ri, lits):
        """Evaluate the join residual over candidate pairs (li, ri); returns
        a boolean keep-mask (NULL -> False)."""
        pair = Mat(
            list(left.names) + list(right.names),
            list(left.types) + list(right.types),
            list(left.dicts) + list(right.dicts),
            [c[li] for c in left.cols] + [c[ri] for c in right.cols],
            [None if v is None else v[li] for v in left.valids]
            + [None if v is None else v[ri] for v in right.valids],
        )
        (v, m), = self._eval_on_mat([node.residual], pair, lits)
        mask = np.asarray(v)
        if mask.ndim == 0:
            mask = np.full(len(li), bool(mask))
        if m is not None:
            mask = mask & np.asarray(m)
        return mask.astype(bool)

    # ==================================================================
    # order / limit / distinct / set ops
    # ==================================================================

    def _sort_indices(self, node_keys, mat: Mat, lits, limit=None) -> np.ndarray:
        keys = []
        for e, desc, nulls_first in reversed(node_keys):
            (v, m), = self._eval_on_mat([e], mat, lits)
            arr = np.asarray(v)
            if arr.ndim == 0:
                arr = np.full(mat.nrows, arr)
            d = self._expr_dict_of(e, mat)
            if d is not None:
                rank = d.rank_array()
                arr = rank[np.minimum(arr, len(rank) - 1)] if len(rank) else arr
            if desc:
                if arr.dtype.kind in "iu" and m is None:
                    arr = -arr.astype(np.int64)  # exact for integer keys
                else:
                    arr = -arr.astype(np.float64)
            # nulls: default NULLS LAST for ASC, NULLS FIRST for DESC (DuckDB)
            if m is not None:
                valid = np.asarray(m)
                nf = nulls_first if nulls_first is not None else desc
                arr = arr.astype(np.float64)
                arr = np.where(valid, arr, -np.inf if nf else np.inf)
            keys.append(arr)
        if not keys:
            return np.arange(mat.nrows)
        budget = getattr(self.config, "memory_limit", None)
        if budget and sum(k.nbytes for k in keys) * 3 > budget // 2 and \
                len(keys[0]) > (1 << 18):
            # out-of-core: external sample sort to a disk-backed
            # permutation (reference merge_sorter.cpp capability)
            from adacom.exec import spill

            P = max(2, (sum(k.nbytes for k in keys) * 3)
                    // max(budget // 8, 1))
            return spill.external_sort_indices(keys, P)
        # sorts run on the host (native LSD radix sort); mesh-sharded sorts
        # happen inside shard_map where the data already lives on device
        # (parallel/ops.py). A device sort is ROADMAP 2.1 work.
        if len(keys) == 1 and len(keys[0]) >= 4096:
            u = _order_preserving_u64(keys[0])
            if u is not None:
                from adacom import native as _native

                return _native.argsort_u64(u)  # LSD radix (RadixSort parity)
        idx = np.lexsort(keys)
        return idx

    def _expr_dict_of(self, e: b.BExpr, mat: Mat):
        if isinstance(e, b.BColumn) and e.index < len(mat.dicts):
            return mat.dicts[e.index] if (e.ty.is_string) else None
        return None

    def _exec_order(self, node: b.LogicalOrder, lits) -> Mat:
        mat = self._exec(node.child, lits)
        if mat.nrows <= 1:
            return mat
        idx = self._sort_indices(node.keys, mat, lits)
        if isinstance(idx, np.memmap):
            # spilled sort: chunk-gather rows into disk-backed columns
            from adacom.exec import spill

            return Mat(
                list(mat.names), list(mat.types), list(mat.dicts),
                [spill.gather(c, idx) for c in mat.cols],
                [None if v is None else spill.gather(v, idx)
                 for v in mat.valids],
            )
        return mat.take(idx)

    def _exec_topn(self, node: b.LogicalTopN, lits) -> Mat:
        mat = self._exec(node.child, lits)
        idx = self._sort_indices(node.keys, mat, lits)
        idx = idx[node.offset : node.offset + node.limit]
        return mat.take(idx)

    def _exec_limit(self, node: b.LogicalLimit, lits) -> Mat:
        mat = self._exec(node.child, lits)
        off = 0
        if node.offset is not None:
            off = int(_const_value(node.offset, lits))
        lim = mat.nrows
        if node.limit is not None:
            lim = int(_const_value(node.limit, lits))
        return mat.take(np.arange(off, min(off + lim, mat.nrows)))

    def _exec_distinct(self, node: b.LogicalDistinct, lits) -> Mat:
        mat = self._exec(node.child, lits)
        if mat.nrows == 0:
            return mat
        uniq_idx = _unique_row_indices(mat.cols)
        return mat.take(np.sort(uniq_idx))

    def _exec_setop(self, node: b.LogicalSetOp, lits) -> Mat:
        left = self._exec(node.left, lits)
        right = self._exec(node.right, lits)
        # harmonize dictionaries: right columns re-encoded into left dicts
        rcols = []
        for c, (lt, rt) in zip(range(len(left.cols)), zip(left.types, node.right.types)):
            rc = right.cols[c]
            ld = left.dicts[c] if c < len(left.dicts) else None
            rd = getattr(node.right, "dicts", [None] * len(right.cols))[c]
            if ld is not None and rd is not None and ld is not rd:
                rc = ld.encode(rd.decode(rc))
            rcols.append(rc)
        if node.op == "union":
            cols = [np.concatenate([l, r.astype(l.dtype)]) for l, r in zip(left.cols, rcols)]
            valids = [
                None if lv is None and rv is None else np.concatenate([
                    lv if lv is not None else np.ones(left.nrows, bool),
                    rv if rv is not None else np.ones(right.nrows, bool),
                ])
                for lv, rv in zip(left.valids, right.valids)
            ]
            mat = Mat(list(node.names), list(node.types),
                      getattr(node, "dicts", [None] * len(node.names)), cols, valids)
            if not node.all:
                idx = _unique_row_indices(mat.cols)
                mat = mat.take(np.sort(idx))
            return mat
        # except / intersect via verified equi-join membership
        li, _ri = _hash_join_pairs(left.cols, rcols, self.config, self.db)
        in_right = np.zeros(left.nrows, dtype=bool)
        in_right[li] = True
        if node.op == "except":
            keep = ~in_right
        else:
            keep = in_right
        mat = left.take(np.nonzero(keep)[0])
        if not node.all:
            idx = _unique_row_indices(mat.cols)
            mat = mat.take(np.sort(idx))
        mat.names = list(node.names)
        return mat


    # ==================================================================
    # window functions
    # ==================================================================

    def _exec_window(self, node: b.LogicalWindow, lits) -> Mat:
        """Reference: PhysicalWindow (physical_window.cpp) — here one sort
        per window (partition-major) + vectorized segmented computation
        (exec/window.py)."""
        mat = self._exec(node.child, lits)
        n = mat.nrows
        cols = list(mat.cols)
        valids = list(mat.valids)
        for w in node.windows:
            if n == 0:
                cols.append(np.empty(0, compute_dtype_of(w.ty)))
                valids.append(None)
                continue
            col, valid = self._compute_window(w, mat, lits)
            cols.append(col)
            valids.append(valid)
        dicts = getattr(node, "dicts", [None] * len(node.names))
        return Mat(list(node.names), list(node.types), list(dicts), cols, valids)

    def _compute_window(self, w: b.BoundWindow, mat: Mat, lits):
        from adacom.exec import window as W

        n = mat.nrows
        # ---- partition ids
        if w.partitions:
            pouts = self._eval_on_mat(w.partitions, mat, lits)
            key_cols = []
            for v, m in pouts:
                a = np.asarray(v)
                if a.ndim == 0:
                    a = np.full(n, a)
                if m is not None:
                    mm = np.asarray(m)
                    if mm.ndim == 0:
                        mm = np.full(n, bool(mm))
                    key_cols.append(np.where(mm, a, np.zeros((), a.dtype)))
                    key_cols.append(mm.astype(np.uint8))
                else:
                    key_cols.append(a)
            part_id = np.unique(_row_keys(key_cols), return_inverse=True)[1]
        else:
            part_id = np.zeros(n, np.int64)

        # ---- order keys (comparable-transformed, priority order)
        okeys = []
        for e, desc, nulls_first in w.order_keys:
            (v, m), = self._eval_on_mat([e], mat, lits)
            arr = np.asarray(v)
            if arr.ndim == 0:
                arr = np.full(n, arr)
            d = self._expr_dict_of(e, mat)
            if d is not None:
                rank = d.rank_array()
                arr = rank[np.minimum(arr, len(rank) - 1)] if len(rank) else arr
            if desc:
                if arr.dtype.kind in "iu" and m is None:
                    arr = -arr.astype(np.int64)
                else:
                    arr = -arr.astype(np.float64)
            if m is not None:
                valid = np.asarray(m)
                nf = nulls_first if nulls_first is not None else desc
                arr = arr.astype(np.float64)
                arr = np.where(valid, arr, -np.inf if nf else np.inf)
            okeys.append(arr)

        sidx = np.lexsort(tuple(reversed(okeys)) + (part_id,))
        p = part_id[sidx]
        pos = np.arange(n, dtype=np.int64)
        starts = W.seg_starts_of(p)
        pstart, pend = W.expand_starts(starts, n)

        if okeys:
            new_peer = np.r_[True, p[1:] != p[:-1]]
            for k in okeys:
                ks = k[sidx]
                new_peer[1:] |= ks[1:] != ks[:-1]
            ps = np.flatnonzero(new_peer)
            peer_start, peer_end = W.expand_starts(ps.astype(np.int64), n)
            has_order = True
        else:
            peer_start, peer_end = pstart, pend
            has_order = False

        # ---- value / constant arguments
        const_args: list = []
        value_args: list = []
        if w.func == "ntile":
            const_args = [int(_const_value(w.args[0], lits))]
        elif w.func in ("lag", "lead"):
            value_args = [w.args[0]]
            off = int(_const_value(w.args[1], lits)) if len(w.args) > 1 else 1
            default = _const_value(w.args[2], lits) if len(w.args) > 2 else None
            const_args = [off, default]
        elif w.func == "nth_value":
            value_args = [w.args[0]]
            const_args = [int(_const_value(w.args[1], lits))]
        elif w.args:
            value_args = [w.args[0]]

        args_sorted = []
        for e in value_args:
            (v, m), = self._eval_on_mat([e], mat, lits)
            arr = np.asarray(v)
            if arr.ndim == 0:
                arr = np.full(n, arr)
            mm = None
            if m is not None:
                mm = np.asarray(m)
                if mm.ndim == 0:
                    mm = np.full(n, bool(mm))
                mm = mm[sidx]
            args_sorted.append((arr[sidx], mm))

        out_s, valid_s = W.compute_sorted(
            w.func, args_sorted, w.frame, has_order,
            pos, pstart, pend, peer_start, peer_end,
            is_decimal_sum=(w.ty.name == "DECIMAL"), const_args=const_args,
        )
        # decimal average: the scaled-integer sum divides out the scale
        if w.func == "avg" and w.args and w.args[0].ty.name == "DECIMAL":
            out_s = out_s / (10.0 ** w.args[0].ty.scale)

        out_s = np.asarray(out_s)
        want = compute_dtype_of(w.ty)
        if out_s.dtype != want and w.ty.name != "VARCHAR":
            out_s = out_s.astype(want)
        out = np.empty(n, out_s.dtype)
        out[sidx] = out_s
        valid = None
        if valid_s is not None:
            valid = np.empty(n, bool)
            valid[sidx] = valid_s
            if valid.all():
                valid = None
        return out, valid


# ======================================================================
# kernel factories
# ======================================================================


def _decode_columns(metas, dtypes, arrays, extra, n_pad):
    """Shared trace fragment: raw arrays -> [(values, valid|None)] padded."""
    cols = []
    k = 0
    for (meta, vflag), dt in zip(metas, dtypes):
        nargs = seg_arg_count(meta)
        dec = make_seg_decoder(meta, dt)
        v = dec(arrays[k : k + nargs])
        k += nargs
        if v.shape[0] != n_pad:
            v = v[:n_pad] if v.shape[0] > n_pad else jnp.pad(v, (0, n_pad - v.shape[0]))
        valid = None
        if vflag == "v":
            vwords = arrays[k]
            k += 1
            valid = bitpack.unpack(vwords, width=1).reshape(-1)[:n_pad].astype(jnp.bool_)
        cols.append((v, valid))
    return cols


def _build_scan_kernel(metas, dtypes, filt, n_pad, has_del):
    import functools

    @functools.partial(jax.jit, static_argnums=())
    def kernel(count, params, extra, *arrays):
        cols = _decode_columns(metas, dtypes, arrays, extra, n_pad)
        mask = tail_mask(n_pad, count)
        if has_del:
            mask = mask & (~extra[0])
        if filt is not None:
            fv, fm = filt.fn(cols, params)
            if hasattr(fv, "shape") and fv.shape == ():
                fv = jnp.broadcast_to(fv, (n_pad,))
            mask = mask & fv
            if fm is not None:
                mask = mask & fm
        return mask, cols

    return kernel


@jax.jit
def _compact_batch(mask, arrays, valid_arrays):
    count, outs = compact_traced(mask, list(arrays) + list(valid_arrays))
    # count travels as a padded vector: tiny/scalar transfers are
    # pathologically slow on the device link
    cnt_vec = jnp.zeros((16,), jnp.int32).at[0].set(count.astype(jnp.int32))
    return cnt_vec, outs


def _scan_agg_body(metas, dtypes, filt, n_pad, spec_entries, group_fns, dense,
                   count, fparams, params, arrays, del_mask=None):
    """Shared trace fragment: one segment's fused decode+filter+partials."""
    cols = _decode_columns(metas, dtypes, arrays, (), n_pad)
    mask = tail_mask(n_pad, count)
    if del_mask is not None:
        mask = mask & (~del_mask)
    if filt is not None:
        fv, fm = filt.fn(cols, fparams)
        if hasattr(fv, "shape") and fv.shape == ():
            fv = jnp.broadcast_to(fv, (n_pad,))
        mask = mask & fv
        if fm is not None:
            mask = mask & fm
    return _agg_partials(cols, mask, params, n_pad, spec_entries, group_fns, dense)


def _build_distributed_scan_agg_kernel(mesh, metas, dtypes, filt, n_pad,
                                       spec_entries, group_fns, dense,
                                       n_arrays):
    """SPMD variant of the pooled scan-aggregate: the same fused
    decode+filter+partials trace runs per device over its shard of the
    stacked segment pool (dp over segments), and partial states merge
    with psum/pmin/pmax over the mesh — the reference's local->global
    sink-state merge (SURVEY.md §2.2) on the mesh collectives. Handles every
    representation the single-chip kernel does (two-plane 64-bit packed,
    validity planes, generic codecs)."""
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    from adacom.parallel.mesh import SEG_AXIS

    def seg_body(count, fparams, params, *arrays):
        return _scan_agg_body(metas, dtypes, filt, n_pad, spec_entries,
                              group_fns, dense, count, fparams, params,
                              arrays)

    def device_body(counts, fparams, params, *arrays_stacked):
        outs = jax.vmap(
            seg_body, in_axes=(0, None, None) + (0,) * len(arrays_stacked)
        )(counts, fparams, params, *arrays_stacked)
        merged = []
        for k, (kind, _, _) in enumerate(spec_entries):
            mk = _merge_kind(kind)
            x = outs[k]
            if mk in ("sum", "count"):
                merged.append(jax.lax.psum(jnp.sum(x, axis=0), SEG_AXIS))
            elif mk == "min":
                merged.append(jax.lax.pmin(jnp.min(x, axis=0), SEG_AXIS))
            else:
                merged.append(jax.lax.pmax(jnp.max(x, axis=0), SEG_AXIS))
        return tuple(merged)

    sharded = shard_map(
        device_body,
        mesh=mesh,
        in_specs=(P(SEG_AXIS), P(), P()) + (P(SEG_AXIS),) * n_arrays,
        out_specs=tuple(P() for _ in spec_entries),
    )
    return jax.jit(sharded)


def _build_pooled_scan_agg_kernel(metas, dtypes, filt, n_pad,
                                  spec_entries, group_fns, dense):
    n_args = sum(seg_arg_count(m) + (1 if v == "v" else 0) for m, v in metas)

    def seg_body(count, fparams, params, *arrays):
        return _scan_agg_body(metas, dtypes, filt, n_pad, spec_entries,
                              group_fns, dense, count, fparams, params, arrays)

    @jax.jit
    def kernel(counts, fparams, params, *arrays_stacked):
        outs = jax.vmap(
            seg_body, in_axes=(0, None, None) + (0,) * len(arrays_stacked)
        )(counts, fparams, params, *arrays_stacked)
        merged = []
        for k, (kind, _, _) in enumerate(spec_entries):
            mk = _merge_kind(kind)
            x = outs[k]
            if mk in ("sum", "count"):
                merged.append(jnp.sum(x, axis=0))
            elif mk == "min":
                merged.append(jnp.min(x, axis=0))
            else:
                merged.append(jnp.max(x, axis=0))
        return tuple(merged)

    return kernel


def _build_scan_agg_kernel(metas, dtypes, filt, n_pad, has_del,
                           spec_entries, group_fns, dense):
    @jax.jit
    def kernel(count, fparams, params, extra, *arrays):
        return _scan_agg_body(
            metas, dtypes, filt, n_pad, spec_entries, group_fns, dense,
            count, fparams, params, arrays,
            del_mask=extra[0] if has_del else None,
        )

    return kernel


def _agg_partials(cols, mask, params, n_pad, spec_entries, group_fns, dense):
    if dense is not None:
        mins, strides, sizes, domain = dense
        keys = [gf(cols, params)[0] for gf in group_fns]
        gid = agg_ops.dense_group_ids(keys, mins, strides, domain)
        # per-spec null-arg masks are pre-applied via neutral values so
        # one shared scatter mask (the filter mask) suffices
        outs = []
        for kind, argf, acc in spec_entries:
            if kind == "count":
                outs.append(agg_ops.grouped_partial(
                    gid, mask, [("count", None, acc)], domain)[0])
                continue
            v, vm = argf(cols, params)
            if hasattr(v, "shape") and v.shape == ():
                v = jnp.broadcast_to(v, (n_pad,))
            if kind == "count_arg":
                ones = jnp.ones(n_pad, jnp.int64)
                if vm is not None:
                    ones = jnp.where(vm, ones, 0)
                outs.append(agg_ops.grouped_partial(
                    gid, mask, [("sum", ones, np.int64)], domain)[0])
                continue
            if vm is not None:
                if kind in ("sum", "sumsq"):
                    v = jnp.where(vm, v, jnp.zeros((), v.dtype))
                elif kind == "min":
                    v = jnp.where(vm, v, jnp.asarray(agg_ops._max_sentinel(acc), v.dtype))
                elif kind == "max":
                    v = jnp.where(vm, v, jnp.asarray(agg_ops._min_sentinel(acc), v.dtype))
            outs.append(agg_ops.grouped_partial(
                gid, mask, [(kind, v, acc)], domain)[0])
        return tuple(outs)

    # ungrouped
    outs = []
    for kind, argf, acc in spec_entries:
        if kind == "count":
            outs.append(agg_ops.masked_count(mask, n_pad))
            continue
        v, vm = argf(cols, params)
        if hasattr(v, "shape") and v.shape == ():
            v = jnp.broadcast_to(v, (n_pad,))
        m = mask if vm is None else (mask & vm)
        if kind == "count_arg":
            outs.append(agg_ops.masked_count(m, n_pad))
        elif kind == "sum":
            outs.append(agg_ops.masked_sum(v, m, acc))
        elif kind == "sumsq":
            vv = v.astype(acc)
            outs.append(agg_ops.masked_sum(vv * vv, m, acc))
        elif kind == "min":
            outs.append(agg_ops.masked_min(v, m, acc, agg_ops._max_sentinel(acc)))
        elif kind == "max":
            outs.append(agg_ops.masked_max(v, m, acc, agg_ops._min_sentinel(acc)))
        else:
            raise ExecError(kind)
    return tuple(outs)



# ======================================================================
# helpers
# ======================================================================


def _pull_partials(partials):
    """Pull partial-aggregate device arrays with batched, padded transfers.

    The device link penalizes tiny/scalar transfers heavily; stacking all
    same-dtype partials into one padded 1-D pull keeps it to one transfer
    per dtype."""
    outs: List[Any] = [None] * len(partials)
    dev: List[int] = []
    for i, p in enumerate(partials):
        if isinstance(p, (np.ndarray, np.generic, int, float)):
            outs[i] = np.asarray(p)
            continue
        dev.append(i)
    if not dev:
        return outs
    # one transfer per dtype class (ints and floats pull separately)
    idx_by: Dict[str, List[int]] = {}
    for i in dev:
        idx_by.setdefault(str(partials[i].dtype), []).append(i)
    for idxs in idx_by.values():
        pieces = [partials[i].reshape(-1) for i in idxs]
        flat = pieces[0] if len(pieces) == 1 else jnp.concatenate(pieces)
        if flat.shape[0] < 16:
            flat = jnp.pad(flat, (0, 16 - flat.shape[0]))
        host = np.asarray(flat)
        off = 0
        for i in idxs:
            shape = partials[i].shape
            n = int(np.prod(shape)) if shape else 1
            chunk = host[off : off + n]
            off += n
            outs[i] = chunk.reshape(shape) if shape else chunk[0]
    return outs


def _merge_kind(kind: str) -> str:
    if kind in ("count", "count_arg", "sum", "sumsq"):
        return "sum" if kind != "count" else "count"
    return kind


def _init_empty_partials(spec_entries, dense):
    outs = []
    domain = dense[2] if dense is not None else None
    for kind, _, acc in spec_entries:
        if dense is not None:
            if kind in ("count", "count_arg"):
                outs.append(np.zeros(domain, np.int64))
            elif kind in ("sum", "sumsq"):
                outs.append(np.zeros(domain, acc))
            elif kind == "min":
                outs.append(np.full(domain, agg_ops._max_sentinel(acc), acc))
            else:
                outs.append(np.full(domain, agg_ops._min_sentinel(acc), acc))
        else:
            if kind in ("count", "count_arg"):
                outs.append(np.int64(0))
            elif kind in ("sum", "sumsq"):
                outs.append(np.zeros((), acc))
            elif kind == "min":
                outs.append(np.asarray(agg_ops._max_sentinel(acc), acc))
            else:
                outs.append(np.asarray(agg_ops._min_sentinel(acc), acc))
    return outs


def _any_count_index(spec_entries):
    for i, (kind, _, _) in enumerate(spec_entries):
        if kind in ("count", "count_arg"):
            return i
    return None


def _agg_finalize_row(node, out_vals):
    cols = []
    valids = []
    for a, v in zip(node.aggregates, out_vals):
        if v is None:
            cols.append(np.zeros(1, compute_dtype_of(a.ty)))
            valids.append(np.zeros(1, bool))
        else:
            cols.append(np.asarray([v]))
            valids.append(None)
    return cols, valids


class _StreamAggFold:
    """Partial-aggregation sink for the streamed join pipeline: morsels
    fold into (group-keys, primitive-partials) state; pending partials
    re-merge whenever they outgrow the merged state (amortized O(n) —
    the reference's local->global radix-partitioned combine,
    partitionable_hashtable.cpp, in vectorized-numpy form)."""

    def __init__(self, ex, node, lits, specs, finishers):
        self.ex = ex
        self.node = node
        self.lits = lits
        self.specs = specs
        self.finishers = finishers
        self.keys_parts: list = []
        self.prims_parts: list = []
        self.rows_pending = 0
        self.merged = None

    def add(self, mat: "Mat") -> None:
        if mat.nrows == 0:
            return
        uniq, prim = self.ex._agg_partials(self.node, mat, self.lits,
                                           self.specs)
        self.keys_parts.append(uniq)
        self.prims_parts.append(prim)
        self.rows_pending += len(prim[0]) if prim else 0
        base = len(self.merged[1][0]) if self.merged else 0
        if self.rows_pending > max(1 << 18, base):
            self._merge()

    def _merge(self) -> None:
        if not self.keys_parts:
            return
        kp, pp = self.keys_parts, self.prims_parts
        if self.merged is not None:
            kp = [self.merged[0]] + kp
            pp = [self.merged[1]] + pp
        self.merged = self.ex._combine_partials(self.node, self.specs,
                                                kp, pp)
        self.keys_parts, self.prims_parts = [], []
        self.rows_pending = 0

    def finish(self) -> "Mat":
        self._merge()
        if self.merged is None:
            # no matching rows anywhere: aggregate an empty batch for the
            # correct empty-group / NULL-sum semantics
            child = self.node.child
            empty = Mat(
                list(child.names), list(child.types),
                list(getattr(child, "dicts", [None] * len(child.names))),
                [np.empty(0, compute_dtype_of(t)) for t in child.types],
                [None] * len(child.types))
            return self.ex._aggregate_host(self.node, empty, self.lits)
        uniq, prim = self.merged
        return self.ex._finish_agg(self.node, self.specs, self.finishers,
                                   uniq, prim)


def _poly_decompose(e: b.BExpr, lits):
    """Expand an integer/DECIMAL scalar expression over scan columns into
    polynomial terms in the SCALED-integer domain.

    Mirrors the engine's decimal arithmetic exactly (exec/expr.py binary
    eval + the binder's typing): '+'/'-' rescale both sides to the max
    scale, '*' multiplies scaled values (scales add). Returns
    (terms, scale) where terms maps a sorted tuple of scan-column indices
    (the monomial; () is the constant term) to an integer coefficient —
    so sum(price * (1 - disc) * (1 + tax)) decomposes to
    1e4*S(price) - 1e2*S(price*disc) + 1e2*S(price*tax) - S(price*disc*tax)
    — or None when the expression doesn't fit (floats, division,
    functions, strings)."""
    if isinstance(e, b.BColumn):
        ty = e.ty
        if ty.is_float or ty.is_string or not (
                ty.integer or ty.name == "DECIMAL"):
            return None
        return {(e.index,): 1}, (ty.scale if ty.name == "DECIMAL" else 0)
    if isinstance(e, b.BLiteral):
        v = lits[e.param] if e.param is not None else e.value
        if v is None or isinstance(v, str):
            return None
        if isinstance(v, float):
            if not float(v).is_integer():
                return None
            v = int(v)
        if e.ty.name == "DECIMAL":
            return {(): int(v)}, e.ty.scale
        if not e.ty.integer:
            return None
        return {(): int(v)}, 0
    if isinstance(e, b.BBinary) and e.op in ("+", "-", "*"):
        lp = _poly_decompose(e.left, lits)
        rp = _poly_decompose(e.right, lits)
        if lp is None or rp is None:
            return None
        lt, ls = lp
        rt, rs = rp
        if e.op in ("+", "-"):
            s = max(ls, rs)
            out: Dict[tuple, int] = {}
            for m, c in lt.items():
                out[m] = out.get(m, 0) + c * 10 ** (s - ls)
            sgn = 1 if e.op == "+" else -1
            for m, c in rt.items():
                out[m] = out.get(m, 0) + sgn * c * 10 ** (s - rs)
            return out, s
        out = {}
        for m1, c1 in lt.items():
            for m2, c2 in rt.items():
                m = tuple(sorted(m1 + m2))
                out[m] = out.get(m, 0) + c1 * c2
        return out, ls + rs
    return None


def _zonemap_probe(f: b.BExpr, lits):
    """Recognize (col op literal) for zonemap skipping; returns
    (col_index, op, value) or None."""
    if not isinstance(f, b.BBinary) or f.op not in ("=", "<", "<=", ">", ">="):
        return None
    l, r = f.left, f.right
    flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}
    if isinstance(l, b.BLiteral) and isinstance(r, b.BColumn):
        l, r = r, l
        op = flip[f.op]
    elif isinstance(l, b.BColumn) and isinstance(r, b.BLiteral):
        op = f.op
    else:
        return None
    lit = r
    val = lits[lit.param] if lit.param is not None else lit.value
    if isinstance(val, str):
        if lit.ty is tt.DATE:
            from adacom.sql.binder import days_from_iso

            val = days_from_iso(val)
        else:
            return None
    if val is None:
        return None
    if l.ty.name == "DECIMAL" and isinstance(val, (int, float)) and lit.ty.name != "DECIMAL":
        val = val * (10 ** l.ty.scale)
    return l.index, op, np.longdouble(val)


def _null_key(dtype):
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return np.nan
    if dt.kind == "u":
        return np.iinfo(dt).max - 7  # improbable sentinel
    return np.iinfo(dt).min + 7


def _row_keys(cols: List[np.ndarray]) -> np.ndarray:
    """Combine row values into a single comparable key (hash; verified
    callers tolerate the astronomically unlikely collision)."""
    if not cols:
        return np.zeros(0, np.uint64)
    h = np.zeros(len(cols[0]), dtype=np.uint64)
    for c in cols:
        x = np.ascontiguousarray(c)
        if x.dtype.kind == "f":
            x = x.view(np.uint64 if x.dtype.itemsize == 8 else np.uint32)
        x = x.astype(np.uint64)
        h ^= (x + np.uint64(0x9E3779B97F4A7C15) + (h << np.uint64(6)) + (h >> np.uint64(2)))
        h *= np.uint64(0xBF58476D1CE4E5B9)
    return h


def _hll_count(gid, vals, valid, n_groups, m: int = 64) -> np.ndarray:
    """Per-group HyperLogLog distinct estimate (reference approx_count via
    third_party/hyperloglog), 64 registers, small-range correction."""
    v = np.asarray(vals)
    if v.dtype.kind == "f":
        v = v.view(np.uint64 if v.dtype.itemsize == 8 else np.uint32)
    h = v.astype(np.uint64)
    # splitmix64 finalizer
    h = (h ^ (h >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    h = (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    h = h ^ (h >> np.uint64(31))
    reg = (h >> np.uint64(58)).astype(np.int64)  # top 6 bits
    w = (h << np.uint64(6)) | np.uint64(1)
    # rho = leading zeros of the remaining bits + 1
    lz = np.uint64(63) - np.floor(np.log2(w.astype(np.float64))).astype(np.uint64)
    rho = (lz + np.uint64(1)).astype(np.int64)
    if valid is not None:
        keep = np.asarray(valid)
        gid_k, reg_k, rho_k = gid[keep], reg[keep], rho[keep]
    else:
        gid_k, reg_k, rho_k = gid, reg, rho
    regs = np.zeros(n_groups * m, dtype=np.int64)
    np.maximum.at(regs, gid_k * m + reg_k, rho_k)
    regs = regs.reshape(n_groups, m)
    alpha = 0.709  # alpha_64
    est = alpha * m * m / np.sum(np.power(2.0, -regs.astype(np.float64)),
                                 axis=1)
    zeros = (regs == 0).sum(axis=1)
    small = est <= 2.5 * m
    with np.errstate(divide="ignore"):
        lin = m * np.log(np.where(zeros > 0, m / np.maximum(zeros, 1), 1.0))
    est = np.where(small & (zeros > 0), lin, est)
    return np.round(est).astype(np.int64)


def _group_quantile(gid, vals, valid, n_groups, q: float, interp: str
                    ) -> np.ndarray:
    """Exact per-group quantile by sorted selection (the reference's
    tdigest approximation replaced with an exact vectorized selection;
    quantile.cpp capability)."""
    v = np.asarray(vals).astype(np.float64)
    g = np.asarray(gid)
    if valid is not None:
        keep = np.asarray(valid)
        v, g = v[keep], g[keep]
    order = np.lexsort((v, g))
    gs, vs = g[order], v[order]
    grange = np.arange(n_groups)
    starts = np.searchsorted(gs, grange, side="left")
    ends = np.searchsorted(gs, grange, side="right")
    cnt = ends - starts
    safe_cnt = np.maximum(cnt, 1)
    if interp == "disc":
        idx = starts + np.maximum(np.ceil(q * safe_cnt).astype(np.int64) - 1, 0)
        idx = np.minimum(idx, np.maximum(ends - 1, 0))
        out = vs[np.minimum(idx, len(vs) - 1)] if len(vs) else np.zeros(n_groups)
    else:
        pos = starts + q * (safe_cnt - 1)
        lo = np.floor(pos).astype(np.int64)
        hi = np.minimum(np.ceil(pos).astype(np.int64),
                        np.maximum(ends - 1, 0))
        lo = np.minimum(lo, np.maximum(ends - 1, 0))
        if len(vs):
            frac = pos - lo
            out = vs[np.minimum(lo, len(vs) - 1)] * (1 - frac) + \
                vs[np.minimum(hi, len(vs) - 1)] * frac
        else:
            out = np.zeros(n_groups)
    return np.where(cnt > 0, out, np.nan)


def _order_preserving_u64(arr: np.ndarray) -> Optional[np.ndarray]:
    """Map a sort key to u64 preserving order (reference key normalization
    to byte-comparable rows, src/common/sort/sort_state.cpp)."""
    if arr.dtype.kind == "i":
        return arr.astype(np.int64).view(np.uint64) ^ np.uint64(1 << 63)
    if arr.dtype.kind == "u":
        return arr.astype(np.uint64)
    if arr.dtype == np.float64:
        bits = arr.view(np.uint64)
        neg = (bits >> np.uint64(63)).astype(bool)
        return np.where(neg, ~bits, bits ^ np.uint64(1 << 63))
    return None


def _unique_rows(key_arrays: List[np.ndarray]):
    """Group-by factorization: returns (unique col arrays, group ids).

    Uses the native open-addressing hash table (GroupedAggregateHashTable
    parity, O(n)) over 64-bit row hashes, then VERIFIES key equality
    against each group's representative row — a colliding row falls back
    to an exact sort-based factorization (the reference compares group
    rows, aggregate_hashtable.cpp FindOrCreateGroups)."""
    from adacom import native as _native

    if len(key_arrays) == 1 and key_arrays[0].dtype.kind in "iu" and \
            key_arrays[0].dtype != np.uint64:
        # single integer key: the value IS the group key — no hashing,
        # no collision verification (Q18's 1.5M-group l_orderkey agg
        # spent half its time in the hash mix)
        h = np.ascontiguousarray(key_arrays[0], dtype=np.int64)
        gid, first_idx = _native.groupby_i64(h)
        return [key_arrays[0][first_idx]], gid
    h = _row_keys(key_arrays)
    if h.dtype != np.int64:
        h = h.view(np.int64) if h.dtype.itemsize == 8 else h.astype(np.int64)
    gid, first_idx = _native.groupby_i64(h)
    rep = first_idx[gid]
    for c in key_arrays:
        cc = np.ascontiguousarray(c)
        same = cc == cc[rep]
        if cc.dtype.kind == "f":  # NaN keys: NaN groups with NaN
            same |= np.isnan(cc) & np.isnan(cc[rep])
        if not same.all():
            return _unique_rows_exact(key_arrays)
    uniq_cols = [c[first_idx] for c in key_arrays]
    return uniq_cols, gid


def _unique_rows_exact(key_arrays: List[np.ndarray]):
    """Exact factorization by lexsort over the actual key columns."""
    n = len(key_arrays[0])
    order = np.lexsort(tuple(reversed(key_arrays)))
    new = np.zeros(n, dtype=bool)
    new[0] = True
    for c in key_arrays:
        cs = np.ascontiguousarray(c)[order]
        diff = cs[1:] != cs[:-1]
        if cs.dtype.kind == "f":
            diff &= ~(np.isnan(cs[1:]) & np.isnan(cs[:-1]))
        new[1:] |= diff
    grp_sorted = np.cumsum(new) - 1
    gid = np.empty(n, dtype=np.int64)
    gid[order] = grp_sorted
    first_idx = np.empty(int(grp_sorted[-1]) + 1, dtype=np.int64)
    # first occurrence in original order for deterministic output
    first_idx[gid[::-1]] = np.arange(n - 1, -1, -1)
    uniq_cols = [c[first_idx] for c in key_arrays]
    return uniq_cols, gid


def _unique_row_indices(cols: List[np.ndarray]) -> np.ndarray:
    """Indices of the first occurrence of each distinct row (verified)."""
    if not cols:
        return np.zeros(1, dtype=np.int64)
    _, gid = _unique_rows([np.ascontiguousarray(c) for c in cols])
    n_groups = int(gid.max()) + 1 if len(gid) else 0
    first = np.full(n_groups, len(gid), dtype=np.int64)
    np.minimum.at(first, gid, np.arange(len(gid)))
    return first


def _gather_rows(c: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Join-output column gather: threaded native kernel for large index
    sets, numpy fancy indexing otherwise."""
    c = np.asarray(c)
    if len(idx) >= 1 << 20 and c.ndim == 1 and c.dtype.itemsize in (1, 4, 8):
        from adacom import native as _native

        out = _native.gather_rows(c, idx)
        if out is not None:
            return out
    return c[idx]


def _hash_join_pairs(lkeys: List[np.ndarray], rkeys: List[np.ndarray],
                     config=None, db=None):
    """All matching (left_idx, right_idx) pairs for equi-keys (vectorized
    sort-probe join with hash-combined multi-column keys + verification).

    With a mesh attached, unique-build-key joins shuffle over all_to_all
    (parallel/ops.make_distributed_join_rowids); otherwise the native
    chained hash table serves every size (JoinHashTable Build/Probe
    parity; a single-device join is ROADMAP 2.1 work)."""
    # single integer key: the value IS the join key — no hashing and, with
    # no collisions possible, no pair verification (uint64 excluded: its
    # top half aliases negative int64 under the common conversion)
    exact = (
        len(lkeys) == 1
        and lkeys[0].dtype.kind in "iu" and rkeys[0].dtype.kind in "iu"
        and lkeys[0].dtype != np.uint64 and rkeys[0].dtype != np.uint64
    )
    if exact:
        lk = np.ascontiguousarray(lkeys[0], dtype=np.int64).view(np.uint64)
        rk = np.ascontiguousarray(rkeys[0], dtype=np.int64).view(np.uint64)
        verify = lambda li, ri: (np.asarray(li, dtype=np.int64),  # noqa: E731
                                 np.asarray(ri, dtype=np.int64))
    else:
        lk = _row_keys([k for k in lkeys])
        rk = _row_keys([k for k in rkeys])
        verify = lambda li, ri: _verify_join_pairs(  # noqa: E731
            lkeys, rkeys, li, ri)
    mesh = getattr(db, "mesh", None) if db is not None else None
    dthresh = getattr(config, "distributed_join_rows", 0) if config else 0
    if mesh is not None and dthresh and len(rk) and \
            len(lk) + len(rk) >= dthresh:
        pair = _distributed_join_pairs(db, mesh, lk, rk)
        if pair is not None:
            return verify(*pair)
    budget = getattr(config, "memory_limit", None) if config else None
    if budget and (len(lk) + len(rk)) * 24 > budget // 2:
        # out-of-core: grace-hash-partitioned join with disk-backed pair
        # streams (reference ProbeSpill, join_hashtable.cpp:16)
        from adacom.exec import spill

        P = max(2, ((len(lk) + len(rk)) * 24) // max(budget // 8, 1))
        li, ri = spill.partitioned_join_pairs(lk, rk, P)
        return spill.verify_pairs_chunked(lkeys, rkeys, li, ri)
    # native chained-bucket hash table with threaded probes (reference
    # JoinHashTable::Build/Probe); falls back to the vectorized numpy
    # sort-probe join without the .so
    from adacom import native as _native

    pair = _native.hash_join_i64(rk.view(np.int64), lk.view(np.int64))
    if pair is not None:
        return verify(*pair)
    order = np.argsort(rk, kind="stable")
    rk_sorted = rk[order]
    lo = np.searchsorted(rk_sorted, lk, side="left")
    hi = np.searchsorted(rk_sorted, lk, side="right")
    counts = hi - lo
    li = np.repeat(np.arange(len(lk)), counts)
    total = int(counts.sum())
    if total == 0:
        return li, np.zeros(0, dtype=np.int64)
    # offsets within each run
    starts = np.repeat(lo, counts)
    base = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(total) - np.repeat(base, counts)
    ri = order[starts + within]
    return verify(li, ri)


_DIST_JOIN_CACHE: Dict[tuple, Any] = {}


def _distributed_join_pairs(db, mesh, lk: np.ndarray, rk: np.ndarray):
    """Shuffle-join the hashed keys over the mesh; returns (li, ri)
    candidate pairs or None when ineligible (duplicate build hashes) or
    unsafe (bin overflow under skew) — callers fall back to the host
    join. Shapes are padded to powers of two to bound recompilation."""
    from adacom.parallel import mesh as pmesh
    from adacom.parallel import ops as pops

    rk64 = rk.view(np.int64)
    lk64 = lk.view(np.int64)
    if len(np.unique(rk64)) != len(rk64):
        return None  # duplicate build keys need run expansion: host path
    n_dev = mesh.devices.size

    def padded_len(n):
        p = 1 << max(1, (n - 1)).bit_length()
        return pmesh.pad_to_multiple(max(p, n_dev), n_dev)

    nb, npr = padded_len(len(rk64)), padded_len(len(lk64))
    capacity = max(64, 4 * (max(nb, npr) // n_dev))
    fkey = (id(mesh), capacity)
    fn = _DIST_JOIN_CACHE.get(fkey)
    if fn is None:
        fn = _DIST_JOIN_CACHE[fkey] = pops.make_distributed_join_rowids(
            mesh, capacity)
        if len(_DIST_JOIN_CACHE) > 16:
            _DIST_JOIN_CACHE.clear()
            _DIST_JOIN_CACHE[fkey] = fn

    def prep(keys, n_pad):
        k = np.zeros(n_pad, np.int64)
        k[: len(keys)] = keys
        v = np.zeros(n_pad, bool)
        v[: len(keys)] = True
        r = np.zeros(n_pad, np.int64)
        r[: len(keys)] = np.arange(len(keys))
        sh = lambda a: pmesh.shard_leading(mesh, jnp.asarray(a))
        return sh(k), sh(v), sh(r)

    bk, bv, br = prep(rk64, nb)
    pk, pv, pr = prep(lk64, npr)
    matched, br_out, pr_out, ovf = fn(bk, bv, br, pk, pv, pr)
    if int(ovf) > 0:
        return None  # skewed bins overflowed: host join is always safe
    m = np.asarray(matched)
    li = np.asarray(pr_out)[m]
    ri = np.asarray(br_out)[m]
    db.dist_stats["join"] += 1
    return li, ri


def _verify_join_pairs(lkeys, rkeys, li, ri):
    """Keep only candidate pairs whose actual keys are equal (hash
    collision safety; the reference compares stored rows the same way)."""
    total = len(li)
    if total == 0:
        return li, np.asarray(ri, dtype=np.int64)
    ok = np.ones(total, dtype=bool)
    for lcol, rcol in zip(lkeys, rkeys):
        lv = lcol[li]
        rv = rcol[ri]
        if lv.dtype.kind == "f" or rv.dtype.kind == "f":
            ok &= lv.astype(np.float64) == rv.astype(np.float64)
        else:
            ok &= lv.astype(np.int64) == rv.astype(np.int64)
    return li[ok], ri[ok]


def _const_value(e: b.BExpr, lits):
    if isinstance(e, b.BLiteral):
        return lits[e.param] if e.param is not None else e.value
    raise ExecError("expected constant")
