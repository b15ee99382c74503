"""Client-surface tests: COPY/read_csv, table functions, DB-API, shell.

Parity with the reference's client layers: COPY to/from file, read_csv /
range table functions (src/function/table/), pythonpkg-style DB-API binding
(tools/pythonpkg), interactive shell (tools/shell)."""

import io
import sys

import numpy as np
import pytest

import adacom as at
from adacom import dbapi
from adacom.main.connection import SQLError


def _db():
    cfg = at.DBConfig()
    cfg.segment_rows = 4096
    db = at.Database(config=cfg)
    return db, db.connect()


# ---------------------------------------------------------------- CSV/COPY


def test_copy_roundtrip(tmp_path):
    db, con = _db()
    con.query("CREATE TABLE t(i BIGINT, x DOUBLE, s VARCHAR)")
    app = con.appender("t")
    app.append_columns({
        "i": np.arange(5_000, dtype=np.int64),
        "x": np.round(np.arange(5_000) * 0.5, 1),
        "s": np.asarray([f"s{k % 11}" for k in range(5_000)], dtype=object),
    })
    app.close()
    p = str(tmp_path / "out.csv")
    n = con.query(f"COPY t TO '{p}' (HEADER)").scalar()
    assert n == 5_000

    con.query("CREATE TABLE t2(i BIGINT, x DOUBLE, s VARCHAR)")
    n = con.query(f"COPY t2 FROM '{p}'").scalar()
    assert n == 5_000
    a = con.query("SELECT SUM(i), COUNT(*) FROM t").fetchall()
    b_ = con.query("SELECT SUM(i), COUNT(*) FROM t2").fetchall()
    assert a == b_
    r = con.query("SELECT s, COUNT(*) FROM t2 GROUP BY s ORDER BY s LIMIT 2").fetchall()
    assert r[0][0] == "s0"
    db.close()


def test_copy_select_to(tmp_path):
    db, con = _db()
    con.query("CREATE TABLE t(i INTEGER)")
    con.query("INSERT INTO t VALUES (3), (1), (2)")
    p = str(tmp_path / "q.csv")
    con.query(f"COPY (SELECT i * 10 AS v FROM t ORDER BY i) TO '{p}'")
    lines = open(p).read().strip().splitlines()
    assert lines == ["v", "10", "20", "30"]
    db.close()


def test_read_csv_table_function(tmp_path):
    p = tmp_path / "data.csv"
    p.write_text("a,b,c\n1,1.5,x\n2,2.5,y\n3,,z\n")
    db, con = _db()
    r = con.query(f"SELECT a, b, c FROM read_csv('{p}') ORDER BY a").fetchall()
    assert r[0] == (1, 1.5, "x") and r[2][0] == 3 and r[2][1] is None
    s = con.query(f"SELECT SUM(a) FROM read_csv('{p}') WHERE c <> 'y'").scalar()
    assert s == 4
    db.close()


def test_range_table_function():
    db, con = _db()
    assert con.query("SELECT COUNT(*) FROM range(100)").scalar() == 100
    assert con.query("SELECT SUM(range) FROM range(5, 10)").scalar() == 35
    r = con.query("SELECT range FROM range(0, 10, 3) ORDER BY range").fetchall()
    assert [x[0] for x in r] == [0, 3, 6, 9]
    db.close()


def test_create_table_as_read_csv(tmp_path):
    p = tmp_path / "d.csv"
    p.write_text("k,v\n1,10\n2,20\n")
    db, con = _db()
    con.query(f"CREATE TABLE imported AS SELECT * FROM read_csv('{p}')")
    assert con.query("SELECT SUM(v) FROM imported").scalar() == 30
    db.close()


# ---------------------------------------------------------------- DB-API


def test_dbapi_basic():
    con = dbapi.connect()
    cur = con.cursor()
    cur.execute("CREATE TABLE t(i INTEGER, s VARCHAR)")
    cur.executemany("INSERT INTO t VALUES (?, ?)",
                    [(1, "a"), (2, "it's"), (None, "n")])
    cur.execute("SELECT i, s FROM t ORDER BY s")
    assert cur.rowcount == 3
    assert cur.description[0][0] == "i"
    rows = cur.fetchall()
    assert (1, "a") in rows and (2, "it's") in rows
    cur.execute("SELECT i FROM t WHERE i = ?", (2,))
    assert cur.fetchone() == (2,)
    assert cur.fetchone() is None
    with pytest.raises(dbapi.DatabaseError):
        cur.execute("SELECT nope FROM t")
    con.close()


def test_dbapi_context_and_iteration():
    with dbapi.connect() as con:
        con.execute("CREATE TABLE t(i INTEGER)")
        con.execute("INSERT INTO t VALUES (1), (2), (3)")
        got = [r[0] for r in con.execute("SELECT i FROM t ORDER BY i")]
        assert got == [1, 2, 3]


# ---------------------------------------------------------------- shell


def test_shell_pipe(monkeypatch, capsys, tmp_path):
    from adacom import shell

    sh = shell.Shell()
    sh.mode = "csv"
    sh.run_sql("CREATE TABLE t(i INTEGER); INSERT INTO t VALUES (1), (2);")
    sh.run_sql("SELECT i, i * 2 AS d FROM t ORDER BY i;")
    out = capsys.readouterr().out
    assert "i,d" in out and "1,2" in out and "2,4" in out
    assert sh.dot_command(".tables")
    out = capsys.readouterr().out
    assert "t" in out
    assert sh.dot_command(".schema t")
    out = capsys.readouterr().out
    assert "CREATE TABLE t" in out
    assert not sh.dot_command(".quit")
    sh.db.close()


def test_using_sample():
    import numpy as np

    import adacom as at

    db = at.Database()
    con = db.connect()
    con.query("CREATE TABLE t(i INTEGER)")
    app = con.appender("t")
    app.append_column("i", np.arange(5000, dtype=np.int32))
    app.close()
    assert con.query("SELECT count(*) FROM t USING SAMPLE 100").scalar() == 100
    assert con.query("SELECT count(*) FROM t USING SAMPLE 10%").scalar() == 500
    assert con.query("SELECT count(*) FROM t TABLESAMPLE 2 PERCENT"
                     ).scalar() == 100
    # sampled rows come from the table (values in-domain), deterministic
    a = con.query("SELECT i FROM t USING SAMPLE 20").fetchall()
    b = con.query("SELECT i FROM t USING SAMPLE 20").fetchall()
    assert a == b and all(0 <= r[0] < 5000 for r in a)
    db.close()


def test_arrow_and_dataframe_results():
    import numpy as np

    import adacom as at

    db = at.Database()
    con = db.connect()
    con.query("CREATE TABLE t(i INTEGER, s VARCHAR)")
    con.query("INSERT INTO t VALUES (1, 'a'), (2, 'b'), (NULL, 'c')")
    res = con.query("SELECT i, s FROM t ORDER BY s")
    tbl = res.fetch_arrow_table()
    assert tbl.num_rows == 3 and tbl.column_names == ["i", "s"]
    assert tbl.column("s").to_pylist() == ["a", "b", "c"]
    df = con.query("SELECT i, s FROM t ORDER BY s").fetchdf()
    assert list(df.columns) == ["i", "s"] and len(df) == 3
    assert df["s"].tolist() == ["a", "b", "c"]
    db.close()


def test_prepared_statements():
    """Connection.prepare + SQL PREPARE/EXECUTE with ? parameters
    (reference PreparedStatement, src/main/prepared_statement.cpp)."""
    import numpy as np

    import adacom as at
    from adacom.main.connection import SQLError

    db = at.Database()
    con = db.connect()
    con.query("CREATE TABLE t(i INTEGER)")
    app = con.appender("t")
    app.append_column("i", np.arange(1000, dtype=np.int32))
    app.close()
    ps = con.prepare("SELECT count(*), sum(i) FROM t WHERE i >= ? AND i < ?")
    assert ps.n_params == 2
    r = ps.execute(10, 20).fetchone()
    assert (int(r[0]), int(r[1])) == (10, sum(range(10, 20)))
    r = ps(0, 1000).fetchone()
    assert int(r[0]) == 1000
    try:
        ps.execute(1)
        raised = False
    except SQLError:
        raised = True
    assert raised
    # SQL-level PREPARE / EXECUTE
    con.query("PREPARE q AS SELECT count(*) FROM t WHERE i < ?")
    assert con.query("EXECUTE q(50)").scalar() == 50
    assert con.query("EXECUTE q(700)").scalar() == 700
    # DML prepared statements
    ins = con.prepare("INSERT INTO t VALUES (?)")
    ins.execute(5000)
    ins.execute(5001)
    assert con.query("SELECT count(*) FROM t WHERE i >= 5000").scalar() == 2
    db.close()


def test_relation_api():
    """Composable Relation API (reference src/main/relation.cpp)."""
    import numpy as np

    import adacom as at

    db = at.Database()
    con = db.connect()
    con.query("CREATE TABLE t(g INTEGER, v INTEGER)")
    app = con.appender("t")
    app.append_columns({"g": (np.arange(1000) % 5).astype(np.int32),
                        "v": np.arange(1000, dtype=np.int32)})
    app.close()
    r = (con.table("t").filter("v >= 100")
         .aggregate("g, sum(v) AS s, count(*) AS c", "g").order("g"))
    rows = r.fetchall()
    assert len(rows) == 5 and int(rows[0][2]) == 180
    assert con.table("t").count() == 1000
    assert con.table("t").filter("v < 10").project("v").limit(3).count() == 3
    j = con.table("t").join(
        con.table("t").project("g AS g2, v AS v2"), "g = g2")
    assert j.count() == 200_000
    assert "Aggregate" in r.explain()
    r.create_view("vw")
    assert con.query("SELECT count(*) FROM vw").scalar() == 5
    # VALUES relation + (VALUES ...) table ref
    assert con.values([(1, "a"), (2, "b")]).fetchall() == [(1, "a"), (2, "b")]
    assert con.query(
        "SELECT sum(col0) FROM (VALUES (1), (2), (3)) v").scalar() == 6
    db.close()
