#!/usr/bin/env python
"""Differential query fuzzer vs sqlite (the reference carries sqlsmith,
extension/sqlsmith; SURVEY §4 lists fuzzing as part of the test
strategy). Generates random SELECTs over a random table and compares
row multisets. Exits non-zero on the first divergence, printing the
reproducing SQL.

Usage: python tools/fuzz_differential.py [n_queries] [seed]"""
import math
import sqlite3
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import adacom as at  # noqa: E402


def make_data(rng, n):
    return {
        "a": rng.integers(-100, 100, n).astype(np.int32),
        "b": rng.integers(0, 10, n).astype(np.int32),
        "c": rng.integers(0, 1 << 40, n),
        "s": np.asarray([f"k{v}" for v in rng.integers(0, 20, n)],
                        dtype=object),
        "f": np.round(rng.normal(0, 50, n), 2),
    }


INT_COLS = ["a", "b", "c"]
AGGS = ["count(*)", "count({c})", "sum({c})", "min({c})", "max({c})",
        "avg({c})"]
CMP = ["=", "<>", "<", "<=", ">", ">="]


def gen_pred(rng):
    parts = []
    for _ in range(rng.integers(1, 4)):
        c = INT_COLS[rng.integers(0, len(INT_COLS))]
        op = CMP[rng.integers(0, len(CMP))]
        v = int(rng.integers(-120, 120))
        p = f"{c} {op} {v}"
        if rng.random() < 0.25:
            p = f"s = 'k{int(rng.integers(0, 25))}'"
        parts.append(p)
    glue = " AND " if rng.random() < 0.7 else " OR "
    return glue.join(parts)


def gen_query(rng):
    kind = rng.random()
    if kind < 0.4:
        aggs = ", ".join(
            AGGS[rng.integers(0, len(AGGS))].format(
                c=INT_COLS[rng.integers(0, len(INT_COLS))])
            for _ in range(rng.integers(1, 4)))
        q = f"SELECT {aggs} FROM t WHERE {gen_pred(rng)}"
    elif kind < 0.75:
        g = ["b", "s"][rng.integers(0, 2)]
        agg = AGGS[rng.integers(1, len(AGGS))].format(
            c=INT_COLS[rng.integers(0, len(INT_COLS))])
        q = (f"SELECT {g}, count(*), {agg} FROM t WHERE {gen_pred(rng)} "
             f"GROUP BY {g} ORDER BY {g}")
    elif kind < 0.9:
        q = (f"SELECT a, b FROM t WHERE {gen_pred(rng)} "
             f"ORDER BY a, b, c LIMIT {int(rng.integers(1, 50))}")
    elif kind < 0.92:
        q = (f"SELECT t1.b, count(*) FROM t t1 JOIN t t2 ON t1.b = t2.b "
             f"WHERE t1.a {CMP[rng.integers(0, 6)]} {int(rng.integers(-50, 50))} "
             f"GROUP BY t1.b ORDER BY t1.b")
    elif kind < 0.94:
        # CTE + HAVING
        q = (f"WITH x AS (SELECT b, sum(a) AS sa, count(*) AS c FROM t "
             f"WHERE {gen_pred(rng)} GROUP BY b) "
             f"SELECT b, sa FROM x WHERE c > {int(rng.integers(1, 50))} "
             f"ORDER BY b")
    elif kind < 0.96:
        # window function over a filtered subset
        q = (f"SELECT a, b, row_number() OVER (PARTITION BY b ORDER BY a, c)"
             f" AS rn FROM t WHERE {gen_pred(rng)} ORDER BY a, b, c "
             f"LIMIT 40")
    elif kind < 0.98:
        # set operation
        lo1, lo2 = int(rng.integers(-50, 0)), int(rng.integers(0, 50))
        op = ["UNION", "UNION ALL", "INTERSECT", "EXCEPT"][
            rng.integers(0, 4)]
        q = (f"SELECT b FROM t WHERE a < {lo1} {op} "
             f"SELECT b FROM t WHERE a > {lo2} ORDER BY b")
    else:
        # CASE + IN list aggregation
        vals = ", ".join(str(int(v)) for v in rng.integers(0, 10, 3))
        q = (f"SELECT CASE WHEN b IN ({vals}) THEN 1 ELSE 0 END AS k, "
             f"count(*), sum(a) FROM t GROUP BY k ORDER BY k")
    return q


def norm(rows):
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
    return sorted(out, key=repr)


def rows_equal(a, b):
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if len(x) != len(y):
            return False
        for p, q in zip(x, y):
            if isinstance(p, float) or isinstance(q, float):
                if p is None or q is None:
                    return False
                if not math.isclose(float(p), float(q), rel_tol=1e-6,
                                    abs_tol=1e-6):
                    return False
            elif p != q:
                return False
    return True


def main():
    n_q = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    rng = np.random.default_rng(seed)
    data = make_data(rng, 20_000)
    db = at.Database(config=at.DBConfig(segment_rows=2048))
    con = db.connect()
    con.query("CREATE TABLE t(a INTEGER, b INTEGER, c BIGINT, s VARCHAR, "
              "f DOUBLE)")
    app = con.appender("t")
    app.append_columns(data)
    app.close()
    db.catalog.get_column_segment_catalog().compact_all_segments()
    lite = sqlite3.connect(":memory:")
    lite.execute("CREATE TABLE t(a INTEGER, b INTEGER, c INTEGER, s TEXT, "
                 "f REAL)")
    lite.executemany("INSERT INTO t VALUES (?,?,?,?,?)", zip(
        data["a"].tolist(), data["b"].tolist(), data["c"].tolist(),
        data["s"].tolist(), data["f"].tolist()))
    bad = 0
    for i in range(n_q):
        q = gen_query(rng)
        try:
            got = norm(con.query(q).fetchall())
        except Exception as e:
            print(f"[{i}] ENGINE ERROR on: {q}\n    {e}")
            bad += 1
            continue
        exp = norm(lite.execute(q).fetchall())
        if not rows_equal(got, exp):
            print(f"[{i}] MISMATCH on: {q}\n  got {got[:3]} ({len(got)})"
                  f"\n  exp {exp[:3]} ({len(exp)})")
            bad += 1
            if bad >= 5:
                break
    print(f"{n_q} queries, {bad} divergences")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
