"""ClickBench-style suite vs a sqlite oracle (same strategy as TPC-H:
row-for-row comparison over identical synthetic data)."""

import math
import sqlite3

import pytest

import adacom as at
from adacom.bench import clickbench as cb


@pytest.fixture(scope="module")
def engines():
    data = cb.generate(scale=0.002)  # 20k rows
    db = at.Database()
    con = db.connect()
    cb.load_into_engine(con, data)
    db.catalog.get_column_segment_catalog().compact_all_segments()
    lite = sqlite3.connect(":memory:")
    cb.load_into_sqlite(lite, data)
    yield con, lite
    db.close()
    lite.close()


def _norm(rows):
    out = []
    for r in rows:
        row = []
        for v in r:
            if v is None:
                row.append(None)
            elif isinstance(v, float) or (hasattr(v, "dtype")
                                          and "float" in str(v.dtype)):
                row.append(round(float(v), 6))
            elif isinstance(v, str):
                row.append(v)
            else:
                row.append(int(v))
        out.append(tuple(row))
    return out


@pytest.mark.parametrize("qid", sorted(cb.QUERIES))
def test_clickbench_query_matches_sqlite(engines, qid):
    con, lite = engines
    sql = cb.QUERIES[qid]
    got = _norm(con.query(sql).fetchall())
    exp = _norm(lite.execute(cb.ORACLE_QUERIES[qid]).fetchall())
    if "ORDER BY" not in sql:
        got, exp = sorted(got), sorted(exp)
    assert len(got) == len(exp), (len(got), len(exp))
    for g, e in zip(got, exp):
        assert len(g) == len(e)
        for gv, ev in zip(g, e):
            if isinstance(gv, float) or isinstance(ev, float):
                assert gv is not None and ev is not None
                assert math.isclose(float(gv), float(ev), rel_tol=1e-9,
                                    abs_tol=1e-9), (qid, g, e)
            else:
                assert gv == ev, (qid, g, e)
