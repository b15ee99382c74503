#!/usr/bin/env python
"""DML differential fuzzer vs sqlite: random INSERT/UPDATE/DELETE
(sometimes inside explicit transactions with random COMMIT/ROLLBACK)
interleaved with SELECT checks; final table state compared row-for-row.

With a third argument "durable", ops run against an on-disk database
and the final comparison happens on a FRESH REOPEN (WAL replay + last
checkpoint), differential-testing crash recovery.

Usage: python tools/fuzz_dml.py [n_ops] [seed] [durable]"""
import sqlite3
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import adacom as at  # noqa: E402


def norm(rows):
    return sorted(tuple(int(v) if v is not None else None for v in r)
                  for r in rows)


def main():
    n_ops = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    durable = len(sys.argv) > 3 and sys.argv[3] == "durable"
    rng = np.random.default_rng(seed)
    path = None
    if durable:
        import tempfile

        path = tempfile.mkdtemp() + "/db"
    db = at.Database(path=path, config=at.DBConfig(segment_rows=1024))
    con = db.connect()
    con.query("CREATE TABLE t(a INTEGER, b INTEGER)")
    lite = sqlite3.connect(":memory:")
    lite.execute("CREATE TABLE t(a INTEGER, b INTEGER)")
    lite.isolation_level = None
    in_txn = False
    for i in range(n_ops):
        r = rng.random()
        if not in_txn and r < 0.1:
            con.query("BEGIN TRANSACTION")
            lite.execute("BEGIN")
            in_txn = True
        elif in_txn and r < 0.25:
            if rng.random() < 0.5:
                con.query("COMMIT")
                lite.execute("COMMIT")
            else:
                con.query("ROLLBACK")
                lite.execute("ROLLBACK")
            in_txn = False
        elif r < 0.55:
            vals = ", ".join(
                f"({int(rng.integers(-50, 50))}, {int(rng.integers(0, 10))})"
                for _ in range(rng.integers(1, 40)))
            con.query(f"INSERT INTO t VALUES {vals}")
            lite.execute(f"INSERT INTO t VALUES {vals}")
        elif r < 0.75:
            lo = int(rng.integers(-60, 40))
            hi = lo + int(rng.integers(1, 30))
            q = f"DELETE FROM t WHERE a >= {lo} AND a < {hi}"
            con.query(q)
            lite.execute(q)
        else:
            lo = int(rng.integers(-60, 40))
            d = int(rng.integers(1, 5))
            q = f"UPDATE t SET b = b + {d} WHERE a >= {lo} AND a < {lo + 10}"
            con.query(q)
            lite.execute(q)
        if rng.random() < 0.2:
            got = norm(con.query("SELECT a, b FROM t").fetchall())
            exp = norm(lite.execute("SELECT a, b FROM t").fetchall())
            if got != exp:
                print(f"[{i}] STATE MISMATCH ({len(got)} vs {len(exp)} "
                      f"rows); first diff: "
                      f"{next((p for p in zip(got, exp) if p[0] != p[1]), None)}")
                return 1
    if in_txn:
        con.query("COMMIT")
        lite.execute("COMMIT")
    if durable:
        # abandon without checkpoint: reopen replays the WAL
        db.close_abrupt() if hasattr(db, "close_abrupt") else None
        db = at.Database(path=path, config=at.DBConfig(segment_rows=1024))
        con = db.connect()
    got = norm(con.query("SELECT a, b FROM t").fetchall())
    exp = norm(lite.execute("SELECT a, b FROM t").fetchall())
    if got != exp:
        print(f"FINAL MISMATCH {len(got)} vs {len(exp)}")
        return 1
    print(f"{n_ops} DML ops{' +replay' if durable else ''}, "
          f"state matches ({len(got)} rows)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
