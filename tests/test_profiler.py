"""Statement verifier + EXPLAIN ANALYZE + profiler tests
(reference src/verification/ + query_profiler.cpp + EXPLAIN ANALYZE)."""

import numpy as np
import pytest

import adacom as at
from adacom.main.connection import SQLError


def _db():
    cfg = at.DBConfig()
    cfg.segment_rows = 4096
    db = at.Database(config=cfg)
    con = db.connect()
    con.query("CREATE TABLE t(i INTEGER, g INTEGER)")
    app = con.appender("t")
    v = np.arange(20_000, dtype=np.int32)
    app.append_columns({"i": v, "g": (v % 5).astype(np.int32)})
    app.close()
    return db, con


def test_verifier_passes_on_correct_queries():
    db, con = _db()
    con.query("SET query_verification_enabled = true")
    r = con.query(
        "SELECT g, COUNT(*) c, SUM(i) s FROM t WHERE i < 1000 "
        "GROUP BY g ORDER BY g").fetchall()
    assert len(r) == 5 and r[0][1] == 200
    r = con.query(
        "SELECT a.g FROM t a JOIN t b ON a.i = b.i WHERE a.i = 7").fetchall()
    assert r == [(2,)]
    db.close()


def test_verifier_catches_mismatch(monkeypatch):
    db, con = _db()
    con.query("SET query_verification_enabled = true")
    from adacom.main import verification

    orig = verification._rows_key

    def corrupt(rows):
        out = orig(rows)
        return out + ["<corrupted>"] if len(out) else out

    calls = {"n": 0}

    def patched(rows):
        calls["n"] += 1
        # corrupt only the variant runs (2nd+ call per verify)
        return corrupt(rows) if calls["n"] > 1 else orig(rows)

    monkeypatch.setattr(verification, "_rows_key", patched)
    with pytest.raises(SQLError, match="mismatch"):
        con.query("SELECT COUNT(*) FROM t WHERE i < 10")
    db.close()


def test_explain_and_analyze():
    db, con = _db()
    r = con.query("EXPLAIN SELECT g, SUM(i) FROM t GROUP BY g")
    text = r.fetchall()[0][0]
    assert "Aggregate" in text and "Get" in text
    r = con.query("EXPLAIN ANALYZE SELECT g, SUM(i) FROM t GROUP BY g")
    text = r.fetchall()[0][0]
    assert "rows=5" in text and "time=" in text and "Total Time" in text
    db.close()


def test_profiler_phases_and_operator_tree():
    db, con = _db()
    con.query("PRAGMA enable_profiling")
    con.query("SELECT COUNT(*) FROM t WHERE i % 2 = 0")
    p = con.last_profile
    assert p["statement"] == "SelectStmt"
    assert "plan_s" in p["phases"] and "execute_s" in p["phases"]
    assert "Aggregate" in p["operators"] and "rows=1" in p["operators"]
    assert p["total_s"] > 0
    db.close()


def test_verifier_prepared_and_external_variants():
    """Prepared (value-free template) + external (fresh connection)
    verifier variants run; statements with bind-time-baked literals skip
    the prepared variant instead of failing (statement_verifier.hpp:17-29
    parity: PREPARED, EXTERNAL)."""
    db, con = _db()
    con.query("SET query_verification_enabled = true")
    # plain parameterized query: all five variants run
    r = con.query("SELECT SUM(i) FROM t WHERE i >= 10 AND i < 500").fetchone()
    assert r[0] == sum(range(10, 500))
    # string-function query: binder bakes the substring args (structural),
    # so the prepared variant must SKIP (not crash) while others verify
    con.query("CREATE TABLE s(v VARCHAR)")
    con.query("INSERT INTO s VALUES ('alpha'), ('beta'), ('alphabet')")
    r = con.query(
        "SELECT count(*) FROM s WHERE substring(v, 1, 4) = 'alph'").fetchone()
    assert int(r[0]) == 2
    db.close()


def test_device_profile_trace_pragmas(tmp_path):
    """PRAGMA device_profile_start/stop capture a jax profiler trace
    (device observability — SURVEY §5.1 'per-op wall counters + jax
    traces')."""
    import os

    db, con = _db()
    d = str(tmp_path / "trace")
    con.query(f"PRAGMA device_profile_start('{d}')")
    con.query("SELECT SUM(i) FROM t")
    r = con.query("PRAGMA device_profile_stop").fetchall()
    assert r == [(d,)]
    n_files = sum(len(f) for _, _, f in os.walk(d))
    assert n_files > 0
    db.close()
