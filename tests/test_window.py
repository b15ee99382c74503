"""Window-function correctness vs a sqlite3 oracle (sqlite >= 3.25 supports
the same window family). The reference covers windows via sqllogictests under
test/sql/window/; here every query runs on identical random data in both
engines and must match row-for-row."""

import sqlite3

import numpy as np
import pytest

import adacom as at


@pytest.fixture(scope="module")
def engines():
    rng = np.random.default_rng(0xA11CE)
    n = 500
    g = rng.integers(0, 7, n).astype(np.int32)
    x = rng.integers(-50, 50, n).astype(np.int32)
    y = rng.integers(0, 1000, n).astype(np.int64)
    f = np.round(rng.normal(0, 10, n), 3)
    s = np.array([f"s{v}" for v in rng.integers(0, 5, n)], dtype=object)

    db = at.Database(config=at.DBConfig(segment_rows=128))
    con = db.connect()
    con.query("CREATE TABLE w(g INTEGER, x INTEGER, y BIGINT, f DOUBLE, s VARCHAR)")
    app = con.appender("w")
    app.append_columns({"g": g, "x": x, "y": y, "f": f, "s": s})
    app.close()

    lite = sqlite3.connect(":memory:")
    lite.execute("CREATE TABLE w(g INTEGER, x INTEGER, y BIGINT, f DOUBLE, s TEXT)")
    lite.executemany(
        "INSERT INTO w VALUES (?,?,?,?,?)",
        [(int(a), int(b), int(c), float(d), str(e))
         for a, b, c, d, e in zip(g, x, y, f, s)],
    )
    return con, lite


QUERIES = [
    "SELECT g, x, y, row_number() OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT g, x, rank() OVER (PARTITION BY g ORDER BY x) FROM w ORDER BY g, x, y",
    "SELECT g, x, dense_rank() OVER (PARTITION BY g ORDER BY x) FROM w ORDER BY g, x, y",
    "SELECT g, x, percent_rank() OVER (PARTITION BY g ORDER BY x) FROM w ORDER BY g, x, y",
    "SELECT g, x, cume_dist() OVER (PARTITION BY g ORDER BY x) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, ntile(3) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, lag(x) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, lag(x, 2) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, lead(y, 1) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, first_value(y) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, last_value(y) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, nth_value(y, 3) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, sum(x) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT g, x, sum(x) OVER (PARTITION BY g) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, count(*) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, min(x) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, max(y) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, avg(x) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, sum(x) OVER (PARTITION BY g ORDER BY x, y ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, sum(x) OVER (PARTITION BY g ORDER BY x, y ROWS BETWEEN 1 PRECEDING AND 3 FOLLOWING) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, min(x) OVER (PARTITION BY g ORDER BY x, y ROWS BETWEEN 4 PRECEDING AND 1 PRECEDING) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, max(x) OVER (PARTITION BY g ORDER BY x, y ROWS BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, sum(x) OVER (PARTITION BY g ORDER BY x, y ROWS BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING) FROM w ORDER BY g, x, y",
    "SELECT g, x, y, sum(f) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    "SELECT x, y, row_number() OVER (ORDER BY y DESC) FROM w ORDER BY x, y",
    "SELECT g, s, x, y, rank() OVER (PARTITION BY s ORDER BY x) FROM w ORDER BY g, s, x, y",
    "SELECT g, x, y, row_number() OVER (PARTITION BY g ORDER BY x, y) + 100 FROM w ORDER BY g, x, y",
    "SELECT g, x, y, lag(x) OVER (PARTITION BY g ORDER BY x, y), lead(x) OVER (PARTITION BY g ORDER BY x, y) FROM w ORDER BY g, x, y",
    # window over aggregate output
    "SELECT g, sum(x) AS s, rank() OVER (ORDER BY sum(x) DESC) FROM w GROUP BY g ORDER BY g",
    "SELECT g, count(*) AS c, row_number() OVER (ORDER BY count(*) DESC, g) FROM w GROUP BY g ORDER BY g",
    # CTE + window
    "WITH t AS (SELECT g, x FROM w WHERE x > 0) SELECT g, x, row_number() OVER (PARTITION BY g ORDER BY x) FROM t ORDER BY g, x",
]


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
            else:
                nr.append(str(v))
        out.append(tuple(nr))
    return out


@pytest.mark.parametrize("qid", range(len(QUERIES)))
def test_window_query(engines, qid):
    con, lite = engines
    sql = QUERIES[qid]
    exp = _norm(lite.execute(sql).fetchall())
    got = _norm(con.query(sql).fetchall())
    # row_number / ntile ties are non-deterministic across engines when the
    # order keys are not unique: these queries all order by (x, y) within
    # (g) partitions of distinct rows or are deterministic by construction;
    # compare as multisets per full ordering prefix to be safe
    assert sorted(got) == sorted(exp), f"{sql}\n got {got[:5]}\n exp {exp[:5]}"
