"""Holistic / extended aggregates: approx_count_distinct (HLL), quantile,
median, bool_and/bool_or (reference src/function/aggregate/{distributive,
holistic}/)."""

import numpy as np
import pytest

import adacom as at


@pytest.fixture()
def db():
    cfg = at.DBConfig()
    cfg.segment_rows = 4096
    d = at.Database(config=cfg)
    yield d
    d.close()


def _load(db, n=50_000, card=1000):
    con = db.connect()
    con.query("CREATE TABLE t(i BIGINT, g INTEGER, x DOUBLE)")
    rng = np.random.default_rng(7)
    vals = rng.integers(0, card, n).astype(np.int64)
    app = con.appender("t")
    app.append_columns({"i": vals, "g": (vals % 4).astype(np.int32),
                        "x": vals.astype(np.float64) / 2.0})
    app.close()
    return con, vals


def test_approx_count_distinct(db):
    con, vals = _load(db)
    est = con.query("SELECT approx_count_distinct(i) FROM t").scalar()
    true = len(np.unique(vals))
    assert abs(est - true) / true < 0.25, (est, true)
    rows = con.query(
        "SELECT g, approx_count_distinct(i) FROM t GROUP BY g ORDER BY g"
    ).fetchall()
    for g, est in rows:
        true = len(np.unique(vals[vals % 4 == g]))
        assert abs(est - true) / true < 0.3, (g, est, true)


def test_median_and_quantiles(db):
    con, vals = _load(db)
    med = con.query("SELECT median(i) FROM t").scalar()
    assert abs(med - np.median(vals)) < 1e-9
    qc = con.query("SELECT quantile_cont(x, 0.25) FROM t").scalar()
    assert abs(qc - np.quantile(vals / 2.0, 0.25)) < 1e-9
    qd = con.query("SELECT quantile_disc(i, 0.9) FROM t").scalar()
    s = np.sort(vals)
    assert qd == s[int(np.ceil(0.9 * len(s))) - 1]
    rows = con.query(
        "SELECT g, median(i) m FROM t GROUP BY g ORDER BY g").fetchall()
    for g, m in rows:
        assert abs(m - np.median(vals[vals % 4 == g])) < 1e-9


def test_median_empty_group(db):
    con = db.connect()
    con.query("CREATE TABLE e(i INTEGER)")
    assert con.query("SELECT median(i) FROM e").scalar() is None


def test_bool_and_or(db):
    con = db.connect()
    con.query("CREATE TABLE b(g INTEGER, p BOOLEAN)")
    con.query("INSERT INTO b VALUES (1, true), (1, true), (2, true), "
              "(2, false), (3, false)")
    rows = con.query(
        "SELECT g, bool_and(p), bool_or(p) FROM b GROUP BY g ORDER BY g"
    ).fetchall()
    assert rows == [(1, True, True), (2, False, True), (3, False, False)]
