"""End-to-end SQL tests, with sqlite3 (stdlib) as the row-for-row oracle for
generic SQL semantics — the analogue of the reference's sqllogictest suite
(test/sql/**, SURVEY.md §4). Every query runs twice: once on plain segments
and once after PRAGMA compact_all_segments (succinct path), both compared
to the oracle."""

import math
import sqlite3

import numpy as np
import pytest

import adacom as at


@pytest.fixture(scope="module")
def engines():
    rng = np.random.default_rng(42)
    n = 20_000
    data = {
        "a": rng.integers(0, 1000, n).astype(np.int64),
        "b": rng.integers(-500, 500, n).astype(np.int64),
        "c": rng.random(n).round(6),
        "s": np.asarray([["red", "green", "blue", "lime", "teal"][k % 5] for k in range(n)], dtype=object),
    }
    db = at.Database(config=at.DBConfig(segment_rows=4096))
    con = db.connect()
    con.query("CREATE TABLE t(a BIGINT, b BIGINT, c DOUBLE, s VARCHAR)")
    app = con.appender("t")
    app.append_columns(data)
    app.close()

    con.query("CREATE TABLE u(k BIGINT, v VARCHAR)")
    con.query("INSERT INTO u VALUES (1,'one'),(2,'two'),(3,'three'),(700,'seven hundred')")

    lite = sqlite3.connect(":memory:")
    lite.execute("CREATE TABLE t(a INTEGER, b INTEGER, c REAL, s TEXT)")
    lite.executemany(
        "INSERT INTO t VALUES (?,?,?,?)",
        zip(data["a"].tolist(), data["b"].tolist(), data["c"].tolist(), data["s"].tolist()),
    )
    lite.execute("CREATE TABLE u(k INTEGER, v TEXT)")
    lite.executemany("INSERT INTO u VALUES (?,?)",
                     [(1, "one"), (2, "two"), (3, "three"), (700, "seven hundred")])
    lite.commit()
    return con, lite


def _norm(rows):
    out = []
    for r in rows:
        nr = []
        for v in r:
            if v is None:
                nr.append(None)
            elif isinstance(v, (float, np.floating)):
                nr.append(round(float(v), 6))
            elif isinstance(v, (int, np.integer)):
                nr.append(int(v))
            elif isinstance(v, (np.str_,)):
                nr.append(str(v))
            elif isinstance(v, (bool, np.bool_)):
                nr.append(int(v))
            else:
                nr.append(v)
        out.append(tuple(nr))
    return out


def check(engines, sql, ordered=False, sqlite_sql=None):
    con, lite = engines
    expected = _norm(lite.execute(sqlite_sql or sql).fetchall())
    for mode in ("plain", "packed"):
        if mode == "packed":
            con.query("PRAGMA compact_all_segments")
        else:
            con.query("PRAGMA uncompact_all")
        got = _norm(con.query(sql).fetchall())
        if not ordered:
            got = sorted(got, key=repr)
            exp = sorted(expected, key=repr)
        else:
            exp = expected
        assert got == exp, f"[{mode}] {sql}\n got {got[:5]}...\n exp {exp[:5]}..."


# ---------------- scans & filters ----------------

def test_count_star(engines):
    check(engines, "SELECT count(*) FROM t")

def test_point_lookup(engines):
    check(engines, "SELECT a FROM t WHERE a = 123")

def test_range_filter(engines):
    check(engines, "SELECT count(*), sum(a), sum(b) FROM t WHERE a < 100 AND b >= 0")

def test_between_and_or(engines):
    check(engines, "SELECT count(*) FROM t WHERE a BETWEEN 10 AND 40 OR b = -7")

def test_in_list(engines):
    check(engines, "SELECT count(*) FROM t WHERE a IN (5, 17, 998)")

def test_not(engines):
    check(engines, "SELECT count(*) FROM t WHERE NOT (a < 500)")

def test_arithmetic_projection(engines):
    check(engines, "SELECT a + b, a * 2, a - b, a % 7 FROM t WHERE a = 77")

def test_string_eq(engines):
    check(engines, "SELECT count(*) FROM t WHERE s = 'green'")

def test_string_like(engines):
    check(engines, "SELECT count(*) FROM t WHERE s LIKE '%e%'")

def test_string_not_like(engines):
    check(engines, "SELECT count(*) FROM t WHERE s NOT LIKE 're%'")

def test_neq(engines):
    check(engines, "SELECT count(*) FROM t WHERE s <> 'red' AND a <> 5")

def test_case_expr(engines):
    check(engines,
          "SELECT sum(CASE WHEN a < 500 THEN 1 ELSE 0 END), "
          "sum(CASE WHEN b > 0 THEN a ELSE -a END) FROM t")

# ---------------- aggregates ----------------

def test_ungrouped_aggs(engines):
    check(engines, "SELECT count(*), sum(a), min(a), max(a), min(b), max(b) FROM t")

def test_avg(engines):
    check(engines, "SELECT avg(a), avg(c) FROM t WHERE b > 100")

def test_group_by_int(engines):
    check(engines, "SELECT b, count(*), sum(a) FROM t WHERE a < 50 GROUP BY b")

def test_group_by_string(engines):
    check(engines, "SELECT s, count(*), sum(a), min(b), max(b) FROM t GROUP BY s")

def test_group_by_two_cols(engines):
    check(engines, "SELECT s, a % 3, count(*) FROM t WHERE a < 300 GROUP BY s, a % 3",
          sqlite_sql="SELECT s, a % 3, count(*) FROM t WHERE a < 300 GROUP BY s, a % 3")

def test_having(engines):
    check(engines, "SELECT b, count(*) FROM t GROUP BY b HAVING count(*) > 25")

def test_count_distinct_groups(engines):
    check(engines, "SELECT count(*) FROM (SELECT s, count(*) FROM t GROUP BY s) x",
          sqlite_sql="SELECT count(*) FROM (SELECT s, count(*) c FROM t GROUP BY s)")

# ---------------- order / limit ----------------

def test_order_by_limit(engines):
    check(engines, "SELECT a, b FROM t WHERE a < 100 ORDER BY a, b LIMIT 20", ordered=True)

def test_order_desc(engines):
    check(engines, "SELECT a FROM t WHERE b = 17 ORDER BY a DESC", ordered=True)

def test_order_by_alias(engines):
    check(engines, "SELECT a + b AS ab FROM t WHERE a < 30 ORDER BY ab LIMIT 10", ordered=True)

def test_order_by_string(engines):
    check(engines, "SELECT s, count(*) FROM t GROUP BY s ORDER BY s", ordered=True)

def test_limit_offset(engines):
    check(engines, "SELECT a FROM t WHERE a < 100 ORDER BY a LIMIT 10 OFFSET 5", ordered=True)

# ---------------- distinct / set ops ----------------

def test_distinct(engines):
    check(engines, "SELECT DISTINCT s FROM t")

def test_union_all(engines):
    check(engines, "SELECT a FROM t WHERE a = 1 UNION ALL SELECT a FROM t WHERE a = 2")

def test_union(engines):
    check(engines, "SELECT s FROM t WHERE a < 100 UNION SELECT v FROM u")

def test_except(engines):
    check(engines, "SELECT DISTINCT a FROM t WHERE a < 20 EXCEPT SELECT a FROM t WHERE a IN (5, 7)")

def test_intersect(engines):
    check(engines, "SELECT DISTINCT a FROM t WHERE a < 50 INTERSECT SELECT k FROM u")

# ---------------- joins ----------------

def test_inner_join(engines):
    check(engines, "SELECT u.v, count(*) FROM t JOIN u ON t.a = u.k GROUP BY u.v")

def test_left_join(engines):
    check(engines,
          "SELECT u.k, count(t.a) FROM u LEFT JOIN t ON t.a = u.k GROUP BY u.k")

def test_join_where(engines):
    check(engines,
          "SELECT t.a, t.b, u.v FROM t, u WHERE t.a = u.k AND t.b > 400")

def test_self_join(engines):
    check(engines,
          "SELECT count(*) FROM u u1 JOIN u u2 ON u1.k = u2.k")

def test_cross_join(engines):
    check(engines, "SELECT count(*) FROM u u1, u u2")

# ---------------- subqueries / CTE / views ----------------

def test_from_subquery(engines):
    check(engines,
          "SELECT s, total FROM (SELECT s, sum(a) AS total FROM t GROUP BY s) x WHERE total > 0")

def test_cte(engines):
    check(engines,
          "WITH big AS (SELECT a, b FROM t WHERE a > 900) SELECT count(*), min(a) FROM big")

def test_view(engines):
    con, lite = engines
    con.query("CREATE OR REPLACE VIEW v1 AS SELECT a, s FROM t WHERE a < 10")
    lite.execute("DROP VIEW IF EXISTS v1")
    lite.execute("CREATE VIEW v1 AS SELECT a, s FROM t WHERE a < 10")
    check(engines, "SELECT s, count(*) FROM v1 GROUP BY s")

# ---------------- DML ----------------

def test_insert_delete_update():
    db = at.Database(config=at.DBConfig(segment_rows=1024))
    con = db.connect()
    con.query("CREATE TABLE x(i INTEGER, s VARCHAR)")
    con.query("INSERT INTO x VALUES (1,'a'),(2,'b'),(3,'c')")
    assert con.query("SELECT count(*) FROM x").scalar() == 3
    con.query("INSERT INTO x SELECT i + 10, s FROM x")
    assert con.query("SELECT count(*) FROM x").scalar() == 6
    con.query("DELETE FROM x WHERE i > 10")
    assert con.query("SELECT count(*) FROM x").scalar() == 3
    con.query("UPDATE x SET i = i * 100 WHERE s = 'b'")
    rows = sorted(con.query("SELECT i FROM x").fetchall())
    assert rows == [(1,), (3,), (200,)]

def test_transaction_rollback():
    db = at.Database()
    con = db.connect()
    con.query("CREATE TABLE x(i INTEGER)")
    con.query("INSERT INTO x VALUES (1),(2)")
    con.query("BEGIN TRANSACTION")
    con.query("INSERT INTO x VALUES (3),(4)")
    assert con.query("SELECT count(*) FROM x").scalar() == 4
    con.query("ROLLBACK")
    assert con.query("SELECT count(*) FROM x").scalar() == 2
    con.query("BEGIN; INSERT INTO x VALUES (9); COMMIT")
    assert con.query("SELECT count(*) FROM x").scalar() == 3

# ---------------- nulls ----------------

def test_null_handling():
    db = at.Database()
    con = db.connect()
    con.query("CREATE TABLE nt(i INTEGER, j INTEGER)")
    con.query("INSERT INTO nt VALUES (1, 10), (2, NULL), (NULL, 30), (4, 40)")
    assert con.query("SELECT count(*) FROM nt").scalar() == 4
    assert con.query("SELECT count(i) FROM nt").scalar() == 3
    assert con.query("SELECT sum(j) FROM nt").scalar() == 80
    assert con.query("SELECT count(*) FROM nt WHERE i IS NULL").scalar() == 1
    assert con.query("SELECT count(*) FROM nt WHERE i IS NOT NULL").scalar() == 3
    # comparisons with NULL are not true
    assert con.query("SELECT count(*) FROM nt WHERE i > 0").scalar() == 3
    assert con.query("SELECT count(*) FROM nt WHERE NOT (i > 0)").scalar() == 0
    assert con.query("SELECT coalesce(i, -1) FROM nt WHERE j = 30").scalar() == -1

# ---------------- dates / decimals ----------------

def test_dates_and_decimals():
    db = at.Database()
    con = db.connect()
    con.query("CREATE TABLE o(d DATE, price DECIMAL(12,2))")
    con.query("INSERT INTO o VALUES ('1994-01-15', 10.50), ('1994-03-01', 20.25), ('1995-01-01', 1.00)")
    assert con.query("SELECT count(*) FROM o WHERE d < DATE '1994-06-01'").scalar() == 2
    assert con.query(
        "SELECT count(*) FROM o WHERE d >= DATE '1994-01-01' AND d < DATE '1994-01-01' + INTERVAL '1' YEAR"
    ).scalar() == 2
    s = con.query("SELECT sum(price) FROM o").scalar()
    assert abs(float(s) - 31.75) < 1e-9
    y = con.query("SELECT extract(year FROM d), count(*) FROM o GROUP BY 1 ORDER BY 1").fetchall()
    assert [(int(a), int(b)) for a, b in y] == [(1994, 2), (1995, 1)]

# ---------------- plan cache ----------------

def test_plan_cache_hit():
    db = at.Database()
    con = db.connect()
    con.query("CREATE TABLE pc(i UINTEGER)")
    app = con.appender("pc")
    app.append_column("i", np.arange(10000, dtype=np.uint32))
    app.close()
    for v in (5, 17, 4999, 9999):
        assert con.query(f"SELECT i FROM pc WHERE i = {v}").scalar() == v
    assert len(db.plan_cache) <= 2  # one template (+alias key)

def test_errors():
    db = at.Database()
    con = db.connect()
    from adacom.main.connection import SQLError
    with pytest.raises(SQLError):
        con.query("SELECT * FROM missing_table")
    with pytest.raises(SQLError):
        con.query("SELEC 1")
    con.query("CREATE TABLE e(i INTEGER)")
    with pytest.raises(Exception):
        con.query("CREATE TABLE e(i INTEGER)")
    con.query("CREATE TABLE IF NOT EXISTS e(i INTEGER)")


# ---------------- subqueries ----------------

def test_scalar_subquery(engines):
    check(engines, "SELECT count(*) FROM t WHERE a > (SELECT avg(a) FROM t)")

def test_in_subquery_semi_join(engines):
    check(engines, "SELECT count(*) FROM t WHERE a IN (SELECT k FROM u)")

def test_not_in_subquery_anti_join(engines):
    check(engines,
          "SELECT count(*) FROM t WHERE a < 100 AND a NOT IN (SELECT k FROM u)")

def test_exists_uncorrelated(engines):
    check(engines, "SELECT count(*) FROM t WHERE EXISTS (SELECT 1 FROM u WHERE k = 700)")
    check(engines, "SELECT count(*) FROM t WHERE NOT EXISTS (SELECT 1 FROM u WHERE k = 701)")

def test_in_subquery_in_or_context(engines):
    check(engines,
          "SELECT count(*) FROM t WHERE a = 999 OR a IN (SELECT k FROM u WHERE k < 5)")


def test_streaming_join_pipeline_engages():
    """Base-table probe sides stream morsel-by-morsel through the native
    hash table (pipeline_executor.cpp parity); dist_stats proves it."""
    import numpy as np

    import adacom as at
    from adacom import native

    if not native.available():
        import pytest

        pytest.skip("native library unavailable")
    db = at.Database(config=at.DBConfig(segment_rows=2048))
    con = db.connect()
    con.query("CREATE TABLE f(k INTEGER, v BIGINT)")
    rng = np.random.default_rng(17)
    k = rng.integers(0, 3000, 50_000).astype(np.int32)
    v = rng.integers(0, 10_000, 50_000)
    app = con.appender("f")
    app.append_columns({"k": k, "v": v})
    app.close()
    con.query("CREATE TABLE d(k INTEGER, grp INTEGER)")
    dk = np.arange(3000, dtype=np.int32)
    dg = (dk % 7).astype(np.int32)
    app = con.appender("d")
    app.append_columns({"k": dk, "grp": dg})
    app.close()
    r = con.query(
        "SELECT d.grp, sum(f.v), count(*) FROM f JOIN d ON f.k = d.k "
        "WHERE f.v >= 100 GROUP BY d.grp ORDER BY d.grp").fetchall()
    streamed = (db.dist_stats.get("streamed_join", 0)
                + db.dist_stats.get("streamed_join_agg", 0))
    assert streamed > 0, "streaming join did not engage"
    m = v >= 100
    for row in r:
        g = int(row[0])
        sel = m & ((k % 7) == g)
        assert int(row[2]) == int(sel.sum())
        assert int(row[1]) == int(v[sel].sum())
    db.close()


def test_differential_fuzz_smoke():
    """50 random queries vs sqlite (sqlsmith analogue, SURVEY §4);
    tools/fuzz_differential.py runs bigger sweeps."""
    import subprocess
    import sys

    r = subprocess.run(
        [sys.executable, "tools/fuzz_differential.py", "50", "7"],
        capture_output=True, text=True, timeout=900,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": "."},
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
