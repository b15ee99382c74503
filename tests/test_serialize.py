"""Plan serialization round-trip + the `deserialized` verifier variant."""

import json

import numpy as np
import pytest

import adacom as at
from adacom.sql.binder import Binder
from adacom.sql.optimizer import optimize
from adacom.sql.parser import parse
from adacom.sql.serialize import deserialize_plan, serialize_plan


@pytest.fixture(scope="module")
def db():
    db = at.Database()
    con = db.connect()
    con.query("CREATE TABLE t(k INTEGER, v BIGINT, s VARCHAR, x DOUBLE)")
    rng = np.random.default_rng(5)
    n = 5000
    app = con.appender("t")
    app.append_columns({
        "k": rng.integers(0, 20, n).astype(np.int32),
        "v": rng.integers(-100, 100, n).astype(np.int64),
        "s": np.asarray(["red", "green", "blue", "teal"], object)[
            rng.integers(0, 4, n)],
        "x": rng.random(n),
    })
    app.close()
    yield db, con
    db.close()


QUERIES = [
    "SELECT k, sum(v), count(*) FROM t GROUP BY k ORDER BY k",
    "SELECT * FROM t WHERE k = 3 AND v > 0 ORDER BY v LIMIT 7",
    "SELECT s, avg(x) FROM t WHERE s <> 'red' GROUP BY s ORDER BY s",
    "SELECT a.k, b.v FROM t a JOIN t b ON a.k = b.k WHERE a.v > 90 ORDER BY a.k, b.v LIMIT 20",
    "SELECT k, CASE WHEN v > 0 THEN 'pos' ELSE 'neg' END AS sgn FROM t WHERE k = 1 ORDER BY v LIMIT 5",
    "SELECT k FROM t WHERE v > (SELECT avg(v) FROM t) ORDER BY k LIMIT 5",
]


@pytest.mark.parametrize("sql", QUERIES)
def test_roundtrip_same_results(db, sql):
    dbi, con = db
    stmts, key, lits, structural = parse(sql)
    binder = Binder(dbi.catalog, dbi.config)
    plan = optimize(binder.bind_select(stmts[0]), set(structural))
    payload = json.dumps(serialize_plan(plan, dbi.catalog))
    plan2 = deserialize_plan(json.loads(payload), dbi.catalog)
    from adacom.exec.executor import Executor
    from adacom.main.result import QueryResult

    r1 = Executor(dbi).execute(plan, lits)
    r2 = Executor(dbi).execute(plan2, lits)
    rows1 = QueryResult(r1.names, r1.types, r1.cols, r1.valids, r1.dicts).fetchall()
    rows2 = QueryResult(r2.names, r2.types, r2.cols, r2.valids, r2.dicts).fetchall()
    assert rows1 == rows2


def test_verifier_runs_all_variants(db):
    dbi, con = db
    con.query("SET query_verification_enabled = true")
    try:
        r = con.query(
            "SELECT k, sum(v) FROM t WHERE k < 10 GROUP BY k ORDER BY k"
        ).fetchall()
        assert len(r) == 10
    finally:
        con.query("SET query_verification_enabled = false")
