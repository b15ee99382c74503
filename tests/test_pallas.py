"""Fused scan-aggregate device tier (decode + filter + aggregate in one
XLA kernel per segment pool, exec/executor.py _scan_agg_batches) against
NumPy: widths 1-32, ragged tails, NULL planes, empty and equality ranges,
and the grouped dense-domain shape."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import adacom as at


def _table(cols, segment_rows=4096, types=None, validity=None):
    """Database with table t(cols...) compacted to succinct segments."""
    cfg = at.DBConfig()
    cfg.segment_rows = segment_rows
    cfg.host_scan_segment_limit = 0
    db = at.Database(config=cfg)
    con = db.connect()
    types = types or {c: "INTEGER" for c in cols}
    con.query("CREATE TABLE t(" + ", ".join(
        f"{c} {types[c]}" for c in cols) + ")")
    app = con.appender("t")
    app.append_columns(cols, validity=validity)
    app.close()
    db.catalog.get_column_segment_catalog().compact_all_segments()
    return db, con


def _device(db, con, sql):
    """Run sql and assert the device scan-aggregate tier served it."""
    before = db.dist_stats.get("device_scan_agg", 0)
    rows = con.query(sql).fetchall()
    assert db.dist_stats.get("device_scan_agg", 0) > before, \
        "device scan-aggregate tier did not engage"
    return rows


@pytest.mark.parametrize("width_span", [1, 250, 4000, (1 << 20) - 1])
def test_scan_sum_count_matches_numpy(width_span):
    n = 65536
    rng = np.random.default_rng(width_span)
    vals = (77 + rng.integers(0, width_span + 1, n)).astype(np.uint32)
    db, con = _table({"i": vals}, segment_rows=n,
                     types={"i": "UINTEGER"})
    lo, hi = 100, 77 + width_span // 2
    sql = f"SELECT count(*), sum(i) FROM t WHERE i >= {lo} AND i <= {hi}"
    # an empty range prunes every segment by zonemap: no device launch
    (r,) = _device(db, con, sql) if lo <= hi else con.query(sql).fetchall()
    m = (vals >= lo) & (vals <= hi)
    assert int(r[0]) == int(m.sum())
    assert (r[1] is None and not m.any()) or \
        int(r[1]) == int(vals[m].astype(np.int64).sum())
    db.close()


@pytest.mark.parametrize("width", [1, 7, 8, 16, 17, 24, 31, 32])
def test_scan_widths_match_numpy(width):
    """Every packed width: min/max/sum/count under a range predicate."""
    rng = np.random.default_rng(width)
    n = 3 * 4096 + 123
    span = (1 << width) - 1
    vals = rng.integers(0, span + 1, n, dtype=np.int64).astype(np.uint32)
    vals[0], vals[1] = 0, span  # pin the segment span to `width` bits
    db, con = _table({"i": vals}, types={"i": "UINTEGER"})
    lo, hi = span // 5, span - span // 7
    (r,) = _device(db, con, "SELECT count(*), sum(i), min(i), max(i) "
                   f"FROM t WHERE i >= {lo} AND i <= {hi}")
    v = vals.astype(np.int64)
    m = (v >= lo) & (v <= hi)
    assert tuple(int(x) for x in r) == (
        int(m.sum()), int(v[m].sum()), int(v[m].min()), int(v[m].max()))
    db.close()


def test_scan_tail_masking():
    n = 65536 - 13  # count below padded size: tail rows must not leak
    vals = np.full(n, 5, dtype=np.uint32)
    vals[0] = 8
    db, con = _table({"i": vals}, segment_rows=65536,
                     types={"i": "UINTEGER"})
    (r,) = _device(db, con,
                   "SELECT count(*), sum(i) FROM t WHERE i >= 0 AND i <= 10")
    assert (int(r[0]), int(r[1])) == (n, 5 * n + 3)
    db.close()


def test_scan_equality_probe():
    n = 131072
    rng = np.random.default_rng(9)
    vals = rng.integers(0, 1000, n).astype(np.uint32)
    db, con = _table({"i": vals}, segment_rows=65536,
                     types={"i": "UINTEGER"})
    (r,) = _device(db, con, "SELECT count(*), sum(i) FROM t WHERE i = 123")
    m = vals == 123
    assert (int(r[0]), int(r[1])) == (int(m.sum()), 123 * int(m.sum()))
    db.close()


def test_scan_table_multi_segment_ragged():
    """Multi-segment scan w/ a ragged tail segment + signed minima."""
    rng = np.random.default_rng(17)
    parts = [(-4000 + k * 3000 + rng.integers(0, 1 << 11, n)).astype(np.int32)
             for k, n in enumerate([8192, 8192, 5000])]
    vals = np.concatenate(parts)
    db, con = _table({"i": vals}, segment_rows=8192)
    a = vals.astype(np.int64)
    for lo, hi in [(-3500, 500), (None, None), (10_000, 20_000)]:
        where = "" if lo is None else f" WHERE i >= {lo} AND i <= {hi}"
        sql = f"SELECT count(*), sum(i), min(i), max(i) FROM t{where}"
        m = np.ones(len(a), bool) if lo is None else (a >= lo) & (a <= hi)
        # zonemaps prune every segment for a range outside the data
        (r,) = _device(db, con, sql) if m.any() else con.query(sql).fetchall()
        assert int(r[0]) == int(m.sum())
        if m.any():
            assert tuple(int(x) for x in r[1:]) == (
                int(a[m].sum()), int(a[m].min()), int(a[m].max()))
        else:
            assert r[1:] == (None, None, None)
    db.close()


def test_engine_pallas_scan_agg():
    """SELECT sum/count/min/max through the device scan-aggregate tier."""
    rng = np.random.default_rng(23)
    vals = rng.integers(-1000, 50_000, 10_000).astype(np.int32)
    db, con = _table({"i": vals})
    (r,) = _device(db, con, "SELECT count(*), sum(i), min(i), max(i) FROM t "
                   "WHERE i >= 100 AND i < 30000")
    m = (vals >= 100) & (vals < 30000)
    assert tuple(int(x) for x in r) == (
        int(m.sum()), int(vals[m].astype(np.int64).sum()),
        int(vals[m].min()), int(vals[m].max()))
    # empty range (pruned by zonemaps) + no-filter variants
    (r,) = con.query("SELECT count(i), sum(i) FROM t WHERE i = 99999"
                     ).fetchall()
    assert int(r[0]) == 0 and r[1] is None
    (r,) = _device(db, con, "SELECT sum(i), count(*) FROM t")
    assert (int(r[0]), int(r[1])) == (int(vals.astype(np.int64).sum()),
                                      len(vals))
    db.close()


def test_driver_scale_kernel_builds():
    """Lower the pooled scan-aggregate kernel at the 100M-row bench shape
    (2048 segments of 65536 rows, 16-bit packed plane) without data."""
    from adacom.exec import executor as ex

    lanes, n_seg = 2048, 2048
    meta = (("packed", ((16,), lanes, "uint32")), None)
    kern = ex._build_pooled_scan_agg_kernel(
        (meta,), [np.uint32], None, 32 * lanes,
        [("count", None, np.int64)], [], None)
    lowered = kern.lower(
        jax.ShapeDtypeStruct((n_seg,), jnp.int32), (), (),
        jax.ShapeDtypeStruct((n_seg, 16, lanes), jnp.uint32),
        jax.ShapeDtypeStruct((n_seg,), jnp.uint32))
    assert "reduce" in lowered.as_text()


def test_grouped_scan_table_matches_numpy(rng):
    """Grouped dense-domain aggregate (perfect-hash-aggregate analogue):
    per-group sum/count over packed group + value planes."""
    n_seg, seg_rows, G = 5, 2048, 6
    g = rng.integers(0, G, n_seg * seg_rows).astype(np.uint32)
    v = (10_000 + rng.integers(0, 50_000, n_seg * seg_rows)).astype(np.uint32)
    db, con = _table({"g": g, "v": v}, segment_rows=seg_rows,
                     types={"g": "UINTEGER", "v": "UINTEGER"})
    for lo, hi in [(None, None), (20_000, 45_000)]:
        where = "" if lo is None else f" WHERE v >= {lo} AND v <= {hi}"
        r = _device(db, con, f"SELECT g, sum(v), count(*) FROM t{where} "
                    "GROUP BY g ORDER BY g")
        keep = np.ones(len(v), bool) if lo is None else (v >= lo) & (v <= hi)
        exp = [(k, int(v[keep & (g == k)].astype(np.int64).sum()),
                int((keep & (g == k)).sum())) for k in range(G)]
        assert [tuple(int(x) for x in row) for row in r] == exp, (lo, hi)
    db.close()


def test_engine_pallas_grouped_agg():
    """SELECT g, sum(v), count(*), avg(v) GROUP BY g through the grouped
    dense-domain device tier (perfect-hash-aggregate analogue)."""
    rng = np.random.default_rng(31)
    g = rng.integers(0, 5, 20_000).astype(np.int32)
    v = rng.integers(100, 90_000, 20_000).astype(np.int32)
    db, con = _table({"g": g, "v": v})
    r = _device(db, con, "SELECT g, sum(v), count(*), avg(v) FROM t "
                "GROUP BY g ORDER BY g")
    assert len(r) == 5
    for row in r:
        m = g == int(row[0])
        assert int(row[1]) == int(v[m].astype(np.int64).sum())
        assert int(row[2]) == int(m.sum())
        assert abs(float(row[3]) - v[m].mean()) < 1e-6
    # filtered variant (value-range predicate folds into the kernel)
    r = _device(db, con, "SELECT g, count(*), sum(v) FROM t "
                "WHERE v >= 10000 AND v < 50000 GROUP BY g ORDER BY g")
    for row in r:
        m = (g == int(row[0])) & (v >= 10000) & (v < 50000)
        assert int(row[1]) == int(m.sum())
        assert int(row[2]) == int(v[m].astype(np.int64).sum())
    db.close()


def test_engine_pallas_scan_agg_with_nulls():
    """Validity planes: sum/count(col) exclude NULLs, count(*) counts all
    rows."""
    rng = np.random.default_rng(29)
    vals = rng.integers(0, 50_000, 20_000).astype(np.int32)
    null = rng.random(20_000) < 0.15
    db, con = _table({"i": vals}, validity={"i": ~null})
    (r,) = _device(db, con, "SELECT count(*), count(i), sum(i) FROM t")
    v64 = vals.astype(np.int64)
    assert int(r[0]) == 20_000
    assert int(r[1]) == int((~null).sum())
    assert int(r[2]) == int(v64[~null].sum())
    (r,) = _device(db, con, "SELECT count(*), sum(i) FROM t "
                   "WHERE i >= 10000 AND i < 30000")
    m = (~null) & (vals >= 10000) & (vals < 30000)
    assert int(r[0]) == int(m.sum())
    assert int(r[1]) == int(v64[m].sum())
    db.close()
