"""TPC-H Q1-class multi-aggregate scans (several SUM/COUNT aggregates over
products of DECIMAL columns, conjunctive range filters, a small dense group
domain) on the device scan-aggregate tier. Every result is compared with
sqlite3 on the same data (reference: the answer-CSV verification ethos,
benchmark/tpch/sf1)."""

import math
import sqlite3

import numpy as np

import adacom as at


def _mkdb(**cfg_kw):
    cfg = at.DBConfig()
    cfg.segment_rows = 2048
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    db = at.Database(config=cfg)
    return db, db.connect()


def _fill(con, n=7000, seed=3):
    """Fill li in the engine; returns a sqlite3 copy (DECIMAL as REAL)."""
    rng = np.random.default_rng(seed)
    con.query("CREATE TABLE li(qty DECIMAL(12,2), price DECIMAL(12,2), "
              "disc DECIMAL(12,2), tax DECIMAL(12,2), rf VARCHAR, "
              "ls VARCHAR, ship DATE)")
    cols = {
        "qty": rng.integers(100, 5001, n),
        "price": rng.integers(90000, 14_000_000, n),
        "disc": rng.integers(0, 11, n),
        "tax": rng.integers(0, 9, n),
        "rf": rng.choice(["A", "N", "R"], n).astype(object),
        "ls": rng.choice(["F", "O"], n).astype(object),
        "ship": rng.integers(10000, 11000, n),
    }
    app = con.appender("li")
    app.append_columns(cols)
    app.close()
    lite = sqlite3.connect(":memory:")
    lite.execute("CREATE TABLE li(qty REAL, price REAL, disc REAL, tax REAL, "
                 "rf TEXT, ls TEXT, ship INTEGER)")
    dec = [c / 100.0 for c in (cols["qty"], cols["price"], cols["disc"],
                               cols["tax"])]
    lite.executemany("INSERT INTO li VALUES (?, ?, ?, ?, ?, ?, ?)", zip(
        *(d.tolist() for d in dec), cols["rf"].tolist(),
        cols["ls"].tolist(), cols["ship"].tolist()))
    return lite


Q1ISH = """
SELECT rf, ls, sum(qty), sum(price), sum(price * (1 - disc)),
       sum(price * (1 - disc) * (1 + tax)), avg(qty), avg(disc), count(*)
FROM li WHERE ship <= 10800 GROUP BY rf, ls ORDER BY rf, ls
"""


def _cmp(r1, r2):
    """Integers and strings exact; floats at rel_tol=1e-9 (sqlite3 sums
    the REAL copies in another order)."""
    assert len(r1) == len(r2)
    for a, c in zip(r1, r2):
        for x, y in zip(a, c):
            if isinstance(x, (float, np.floating)):
                assert math.isclose(x, y, rel_tol=1e-9), (a, c)
            else:
                assert x == y, (a, c)


def _device(db, con, sql):
    before = db.dist_stats.get("device_scan_agg", 0)
    rows = con.query(sql).fetchall()
    assert db.dist_stats.get("device_scan_agg", 0) > before, \
        "device tier did not engage"
    return rows


def test_q1_shape_matches_host():
    db, con = _mkdb()
    lite = _fill(con)
    db.catalog.get_column_segment_catalog().compact_all_segments()
    _cmp(_device(db, con, Q1ISH), lite.execute(Q1ISH).fetchall())
    db.close()


def test_ungrouped_multi_filter_sum_matches_host():
    """Q6 shape: sum(price*disc) under range filters on THREE columns."""
    db, con = _mkdb()
    lite = _fill(con)
    db.catalog.get_column_segment_catalog().compact_all_segments()
    q = ("SELECT sum(price * disc), count(*) FROM li "
         "WHERE ship >= 10100 AND ship < 10400 AND disc >= 0.02 "
         "AND disc <= 0.06 AND qty < 24")
    _cmp(_device(db, con, q), lite.execute(q).fetchall())
    db.close()


def test_empty_predicate_and_absent_groups():
    db, con = _mkdb()
    _fill(con, n=3000)
    db.catalog.get_column_segment_catalog().compact_all_segments()
    r = con.query("SELECT rf, sum(price) FROM li WHERE ship > 99999 "
                  "GROUP BY rf").fetchall()
    assert r == []
    db.close()


def test_uncompacted_falls_back_to_host():
    db, con = _mkdb()
    lite = _fill(con, n=3000)
    # no compaction: plain segments, results still correct
    _cmp(con.query(Q1ISH).fetchall(), lite.execute(Q1ISH).fetchall())
    db.close()


def test_deletes_fall_back_and_stay_correct():
    db, con = _mkdb()
    lite = _fill(con, n=4000)
    db.catalog.get_column_segment_catalog().compact_all_segments()
    con.query("DELETE FROM li WHERE qty < 10")
    lite.execute("DELETE FROM li WHERE qty < 10")
    _cmp(con.query(Q1ISH).fetchall(), lite.execute(Q1ISH).fetchall())
    db.close()


def test_poly_decompose():
    from adacom.exec.executor import _poly_decompose
    from adacom.sql import bound as b
    from adacom import types as tt

    dec2 = tt.DECIMAL(12, 2)
    price = b.BColumn(dec2, 1, "price")
    disc = b.BColumn(dec2, 2, "disc")
    one = b.BLiteral(tt.BIGINT, 1)
    # price * (1 - disc): scale 4, {(1,): 100, (1,2): -1}
    e = b.BBinary(tt.DECIMAL(38, 4), "*", price,
                  b.BBinary(tt.DECIMAL(38, 2), "-", one, disc))
    terms, scale = _poly_decompose(e, ())
    assert scale == 4
    assert terms == {(1,): 100, (1, 2): -1}
    # non-decomposable: division
    e2 = b.BBinary(tt.DOUBLE, "/", price, disc)
    assert _poly_decompose(e2, ()) is None


def test_auto_index_builds_and_serves():
    db, con = _mkdb(auto_index_threshold=8)
    rng = np.random.default_rng(11)
    n = 20_000
    # interleaved keys: zonemaps cannot prune -> every segment scans
    keys = rng.permutation(n).astype(np.uint64) * np.uint64(1 << 40) \
        | rng.integers(0, 1 << 20, n).astype(np.uint64)
    con.query("CREATE TABLE t(i UBIGINT)")
    app = con.appender("t")
    app.append_column("i", keys)
    app.close()
    db.catalog.get_column_segment_catalog().compact_all_segments()
    for v in keys[:20]:
        r = con.query(f"SELECT i FROM t WHERE i == {v}").fetchall()
        assert len(r) == 1 and int(r[0][0]) == int(v)
    assert db.dist_stats.get("auto_index_built", 0) == 1
    t = db.catalog.get_table("t")
    assert any(ix.name.startswith("__auto_") for ix in t.indexes)
    # lookups after the build stay correct, including misses
    assert con.query("SELECT i FROM t WHERE i == 12345").row_count == 0
    # and appends after the auto-index still work + are found
    con.query("INSERT INTO t VALUES (777)")
    assert con.query("SELECT i FROM t WHERE i == 777").row_count == 1
    db.close()


def test_count_star_plain_wide_segments():
    """Regression: bare count(*) over PLAIN (non-succinct) full-width
    segments once slipped into the multi tier with zero word planes; the
    lane grid defaulted to TILE_L and every 65536-row segment counted as
    32768 (found by SequentialInsert verification at scale 1.0)."""
    cfg = at.DBConfig()
    cfg.succinct_enabled = False  # plain segments, default 65536 rows
    db = at.Database(config=cfg)
    try:
        con = db.connect()
        con.query("CREATE TABLE t(i UINTEGER)")
        n = 200_000
        app = con.appender("t")
        app.append_column("i", np.arange(n, dtype=np.uint32))
        app.close()
        assert int(con.query("SELECT count(*) FROM t").scalar()) == n
        r = con.query("SELECT count(*), sum(i) FROM t").fetchone()
        assert int(r[0]) == n and int(r[1]) == n * (n - 1) // 2
    finally:
        db.close()


def test_twelve_group_domain_rides_multi_tier():
    """A 12-group domain with a product aggregate on the device tier."""
    cfg = at.DBConfig()
    cfg.segment_rows = 4096
    db = at.Database(config=cfg)
    try:
        con = db.connect()
        rng = np.random.default_rng(6)
        n = 30_000
        con.query("CREATE TABLE t(g INTEGER, v DECIMAL(12,2), "
                  "w DECIMAL(12,2))")
        app = con.appender("t")
        g = rng.integers(0, 12, n).astype(np.int32)
        v = rng.integers(0, 10_000, n)
        w = rng.integers(0, 50, n)
        app.append_columns({"g": g, "v": v, "w": w})
        app.close()
        db.catalog.get_column_segment_catalog().compact_all_segments()
        q = ("SELECT g, sum(v * w), sum(v), count(*) FROM t "
             "WHERE v >= 10 GROUP BY g ORDER BY g")
        r1 = _device(db, con, q)
        assert len(r1) == 12
        keep = v >= 1000  # v >= 10.00 at scale 2
        exp = [(k, int((v * w)[keep & (g == k)].sum()) / 10_000,
                int(v[keep & (g == k)].sum()) / 100,
                int((keep & (g == k)).sum())) for k in range(12)]
        _cmp(r1, exp)
    finally:
        db.close()


def test_left_join_pipeline_null_counts():
    """Aggregate over a LEFT JOIN rides the streamed pipeline; unmatched
    rows carry NULL right columns so count(right_col) skips them (TPC-H
    Q13 shape)."""
    cfg = at.DBConfig()
    cfg.segment_rows = 2048
    db = at.Database(config=cfg)
    try:
        con = db.connect()
        rng = np.random.default_rng(19)
        con.query("CREATE TABLE c(ck INTEGER)")
        app = con.appender("c")
        app.append_column("ck", np.arange(6000, dtype=np.int32))
        app.close()
        con.query("CREATE TABLE o(ck INTEGER, ok INTEGER)")
        # only even customers have orders, 0-3 each
        cks, oks = [], []
        k = 0
        for ck in range(0, 6000, 2):
            for _ in range(int(rng.integers(0, 4))):
                cks.append(ck)
                oks.append(k)
                k += 1
        app = con.appender("o")
        app.append_columns({"ck": np.asarray(cks, np.int32),
                            "ok": np.asarray(oks, np.int32)})
        app.close()
        db.catalog.get_column_segment_catalog().compact_all_segments()
        q = ("SELECT c.ck, count(o.ok) FROM c LEFT JOIN o ON c.ck = o.ck "
             "GROUP BY c.ck ORDER BY c.ck")
        r1 = con.query(q).fetchall()
        assert len(r1) == 6000
        assert db.dist_stats.get("streamed_join_agg", 0) >= 1
        import collections
        exp = collections.Counter(cks)
        for row in r1:
            assert int(row[1]) == exp.get(int(row[0]), 0), row
        db.config.streaming_agg_sink_enabled = False
        r2 = db.connect().query(q).fetchall()
        assert r1 == r2
    finally:
        db.close()
