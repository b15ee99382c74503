"""TPC-H query correctness vs a sqlite3 oracle on identical synthetic data
(the engine-agnostic analogue of the reference's answer-CSV verification,
SURVEY.md §4 benchmark-as-test). Runs each query on plain and on compacted
(succinct) segments."""

import sqlite3

import numpy as np
import pytest

import adacom as at
from adacom.bench import tpch


@pytest.fixture(scope="module")
def engines():
    data = tpch.generate(sf=0.01)
    db = at.Database(config=at.DBConfig(segment_rows=8192))
    con = db.connect()
    tpch.load_into_engine(con, data)
    lite = sqlite3.connect(":memory:")
    tpch.load_into_sqlite(lite, data)
    return con, lite


def _norm(rows):
    out = []
    for r in rows:
        nr = []
        for v in r:
            if v is None:
                nr.append(None)
            elif isinstance(v, (float, np.floating)):
                nr.append(float(v))
            elif isinstance(v, (int, np.integer)):
                nr.append(int(v))
            else:
                nr.append(str(v))
        out.append(tuple(nr))
    return out


def _rows_equal(got, exp):
    import math

    if len(got) != len(exp):
        return False
    for g, e in zip(got, exp):
        if len(g) != len(e):
            return False
        for a, b in zip(g, e):
            if isinstance(a, float) or isinstance(b, float):
                # our decimal sums are exact int64; the sqlite oracle
                # accumulates REALs -> allow float round-off
                if not math.isclose(float(a), float(b), rel_tol=1e-9, abs_tol=1e-6):
                    return False
            elif a != b:
                return False
    return True


@pytest.mark.parametrize("qid", sorted(tpch.QUERIES))
@pytest.mark.parametrize("mode", ["plain", "packed"])
def test_tpch_query(engines, qid, mode):
    con, lite = engines
    if mode == "packed":
        con.query("PRAGMA compact_all_segments")
    else:
        con.query("PRAGMA uncompact_all")
    sql = tpch.QUERIES[qid]
    exp = _norm(lite.execute(tpch.oracle_sql(qid)).fetchall())
    got = _norm(con.query(sql).fetchall())
    ordered = "ORDER BY" in sql
    if not ordered:
        got, exp = sorted(got, key=repr), sorted(exp, key=repr)
    assert _rows_equal(got, exp), f"Q{qid} [{mode}]:\n got {got[:4]}\n exp {exp[:4]}"
