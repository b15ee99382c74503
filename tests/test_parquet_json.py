"""Parquet + JSON extension tests (reference extension/parquet,
extension/json): read_parquet/read_json table functions and COPY TO/FROM
with FORMAT PARQUET."""

import json

import numpy as np
import pytest

import adacom as at

pytest.importorskip("pyarrow")


@pytest.fixture()
def con():
    db = at.Database()
    c = db.connect()
    yield c
    db.close()


def _write_sample_parquet(path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    t = pa.table({
        "i": pa.array([1, 2, None, 4], type=pa.int32()),
        "f": pa.array([1.5, None, 3.5, 4.0]),
        "s": pa.array(["a", "bb", None, "dd"]),
        "d": pa.array([0, 9496, None, 11323], type=pa.int32()).cast(
            pa.date32()),
    })
    pq.write_table(t, path)


def test_read_parquet(con, tmp_path):
    p = str(tmp_path / "x.parquet")
    _write_sample_parquet(p)
    rows = con.query(f"SELECT * FROM read_parquet('{p}')").fetchall()
    assert len(rows) == 4
    assert tuple(rows[0]) == (1, 1.5, "a", rows[0][3])
    assert str(rows[0][3]) == "1970-01-01"
    assert str(rows[3][3]) == "2001-01-01"
    assert rows[2][0] is None and rows[1][1] is None and rows[2][2] is None
    # aggregate over parquet source
    r = con.query(
        f"SELECT count(*), sum(i) FROM read_parquet('{p}')").fetchone()
    assert (int(r[0]), int(r[1])) == (4, 7)


def test_copy_roundtrip_parquet(con, tmp_path):
    p = str(tmp_path / "out.parquet")
    con.query("CREATE TABLE t(a BIGINT, b DOUBLE, c VARCHAR, d DATE)")
    con.query("INSERT INTO t VALUES (1, 1.5, 'x', '1996-03-13'), "
              "(2, NULL, 'yy', NULL), (3, 2.5, NULL, '2000-01-01')")
    n = con.query(f"COPY t TO '{p}' (FORMAT PARQUET)").fetchone()[0]
    assert int(n) == 3
    rows = con.query(f"SELECT * FROM read_parquet('{p}') ORDER BY a"
                     ).fetchall()
    assert len(rows) == 3
    assert tuple(rows[0])[:3] == (1, 1.5, "x")
    assert str(rows[0][3]) == "1996-03-13"
    assert rows[1][1] is None and rows[1][3] is None and rows[2][2] is None
    # COPY FROM parquet into a fresh table
    con.query("CREATE TABLE t2(a BIGINT, b DOUBLE, c VARCHAR, d DATE)")
    n2 = con.query(f"COPY t2 FROM '{p}'").fetchone()[0]
    assert int(n2) == 3
    assert con.query("SELECT count(*), sum(a) FROM t2").fetchone() == \
        con.query("SELECT count(*), sum(a) FROM t").fetchone()


def test_read_json_ndjson(con, tmp_path):
    p = str(tmp_path / "x.ndjson")
    with open(p, "w") as f:
        f.write('{"a": 1, "s": "x", "f": 1.5}\n')
        f.write('{"a": 2, "s": "yy"}\n')
        f.write('{"a": null, "s": "z", "f": 2.5, "extra": true}\n')
    rows = con.query(
        f"SELECT a, s, f, extra FROM read_json('{p}')").fetchall()
    assert len(rows) == 3
    assert tuple(rows[0]) == (1, "x", 1.5, None)
    assert rows[1][2] is None  # missing key -> NULL
    assert rows[2][0] is None and bool(rows[2][3]) is True
    r = con.query(f"SELECT sum(a), count(f) FROM read_json('{p}')").fetchone()
    assert (int(r[0]), int(r[1])) == (3, 2)


def test_read_json_array(con, tmp_path):
    p = str(tmp_path / "arr.json")
    with open(p, "w") as f:
        json.dump([{"k": "a", "v": 10}, {"k": "b", "v": 20}], f)
    rows = con.query(
        f"SELECT k, v FROM read_json('{p}') ORDER BY v DESC").fetchall()
    assert [tuple(r) for r in rows] == [("b", 20), ("a", 10)]


def test_json_dates_and_nested(con, tmp_path):
    p = str(tmp_path / "d.ndjson")
    with open(p, "w") as f:
        f.write('{"d": "1996-03-13", "obj": {"x": 1}}\n')
        f.write('{"d": "2000-12-31", "obj": [1, 2]}\n')
    rows = con.query(f"SELECT d, obj FROM read_json('{p}')").fetchall()
    assert str(rows[0][0]) == "1996-03-13"
    # nested values stringify to their JSON text
    assert json.loads(rows[0][1]) == {"x": 1}
    assert json.loads(rows[1][1]) == [1, 2]
