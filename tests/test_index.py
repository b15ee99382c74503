"""Index tests (storage/index.py): the reference ART's capability envelope —
point lookups, uniqueness enforcement, index-scan rewrite, persistence."""

import numpy as np
import pytest

import adacom as at
from adacom.main.connection import SQLError


def _db(segment_rows=4096, path=None):
    cfg = at.DBConfig()
    cfg.segment_rows = segment_rows
    db = at.Database(path=path, config=cfg)
    return db, db.connect()


def test_create_index_and_lookup():
    db, con = _db()
    con.query("CREATE TABLE t(i BIGINT, x INTEGER)")
    app = con.appender("t")
    rng = np.random.default_rng(4)
    keys = rng.permutation(30_000).astype(np.int64)
    app.append_columns({"i": keys, "x": (keys % 7).astype(np.int32)})
    app.close()
    con.query("CREATE INDEX idx_i ON t(i)")
    for probe in (0, 17, 29_999, 12_345):
        r = con.query(f"SELECT i, x FROM t WHERE i = {probe}").fetchall()
        assert r == [(probe, probe % 7)], (probe, r)
    assert con.query("SELECT i FROM t WHERE i = -5").fetchall() == []
    con.query("DROP INDEX idx_i")
    r = con.query("SELECT i FROM t WHERE i = 17").fetchall()
    assert r == [(17, )] or r == [(17, 3)]
    db.close()


def test_unique_index_rejects_duplicates():
    db, con = _db()
    con.query("CREATE TABLE t(i INTEGER)")
    con.query("INSERT INTO t VALUES (1), (2), (3)")
    con.query("CREATE UNIQUE INDEX u ON t(i)")
    with pytest.raises(SQLError, match="duplicate"):
        con.query("INSERT INTO t VALUES (2)")
    with pytest.raises(SQLError, match="duplicate"):
        con.query("INSERT INTO t VALUES (7), (7)")
    con.query("INSERT INTO t VALUES (4)")
    assert con.query("SELECT COUNT(*) FROM t").scalar() == 4
    db.close()


def test_unique_index_existing_duplicates_rejected():
    db, con = _db()
    con.query("CREATE TABLE t(i INTEGER)")
    con.query("INSERT INTO t VALUES (1), (1)")
    with pytest.raises(SQLError, match="duplicate"):
        con.query("CREATE UNIQUE INDEX u ON t(i)")
    db.close()


def test_primary_key_constraint():
    db, con = _db()
    con.query("CREATE TABLE t(id INTEGER PRIMARY KEY, v VARCHAR)")
    con.query("INSERT INTO t VALUES (1, 'a'), (2, 'b')")
    with pytest.raises(SQLError, match="duplicate"):
        con.query("INSERT INTO t VALUES (1, 'dup')")
    # table-level constraint syntax
    con.query("CREATE TABLE t2(a INTEGER, b INTEGER, PRIMARY KEY (a))")
    con.query("INSERT INTO t2 VALUES (5, 6)")
    with pytest.raises(SQLError, match="duplicate"):
        con.query("INSERT INTO t2 VALUES (5, 9)")
    db.close()


def test_index_with_deletes():
    db, con = _db()
    con.query("CREATE TABLE t(i INTEGER)")
    app = con.appender("t")
    app.append_column("i", np.arange(10_000, dtype=np.int32))
    app.close()
    con.query("CREATE INDEX idx ON t(i)")
    con.query("DELETE FROM t WHERE i = 777")
    assert con.query("SELECT COUNT(*) FROM t WHERE i = 777").scalar() == 0
    assert con.query("SELECT COUNT(*) FROM t WHERE i = 778").scalar() == 1
    db.close()


def test_index_survives_reopen(tmp_path):
    db, con = _db(path=str(tmp_path / "d"))
    con.query("CREATE TABLE t(i INTEGER PRIMARY KEY)")
    con.query("INSERT INTO t VALUES (1), (2)")
    db.close()
    db2, con2 = _db(path=str(tmp_path / "d"))
    assert "pk_t_i" in db2.catalog.indexes
    with pytest.raises(SQLError, match="duplicate"):
        con2.query("INSERT INTO t VALUES (2)")
    db2.close()


def test_index_range_lookup_api():
    db, con = _db()
    con.query("CREATE TABLE t(i INTEGER)")
    app = con.appender("t")
    app.append_column("i", np.random.default_rng(9).permutation(20_000).astype(np.int32))
    app.close()
    idx = db.catalog.create_index("r", "t", "i")
    hits = idx.lookup_range(100, 199)
    total = sum(len(rows) for _, rows in hits)
    assert total == 100
    table = db.catalog.get_table("t")
    for seg_idx, rows in hits:
        vals = table.columns["i"].segments[seg_idx]._host_compute_values()[rows]
        assert ((vals >= 100) & (vals <= 199)).all()
    db.close()


def test_composite_index_eq_lookup():
    """CREATE INDEX over (a, b): composite equality probes via the
    hash-sorted permutation (reference ART composite keys, art.cpp:929)."""
    import numpy as np

    import adacom as at

    db = at.Database(config=at.DBConfig(segment_rows=2048))
    con = db.connect()
    con.query("CREATE TABLE t(a INTEGER, b INTEGER, p INTEGER)")
    rng = np.random.default_rng(5)
    a = rng.integers(0, 50, 10_000).astype(np.int32)
    b = rng.integers(0, 40, 10_000).astype(np.int32)
    p = np.arange(10_000, dtype=np.int32)
    app = con.appender("t")
    app.append_columns({"a": a, "b": b, "p": p})
    app.close()
    con.query("CREATE INDEX iab ON t(a, b)")
    idx = db.catalog.get_table("t").index_on_columns(["a", "b"])
    assert idx is not None and idx.composite
    hits = idx.lookup_eq((7, 13))
    got = np.sort(np.concatenate(
        [r + si * 2048 for si, r in hits])) if hits else np.empty(0)
    exp = np.nonzero((a == 7) & (b == 13))[0]
    np.testing.assert_array_equal(got, exp)
    db.close()


def test_index_join_probes_instead_of_scanning():
    """Small probe side + indexed big side -> the index join materializes
    only matching inner rows (dist_stats['index_join'] proves the path)."""
    import numpy as np

    import adacom as at

    db = at.Database(config=at.DBConfig(segment_rows=4096))
    con = db.connect()
    con.query("CREATE TABLE big(k INTEGER, v BIGINT)")
    rng = np.random.default_rng(6)
    k = rng.permutation(200_000).astype(np.int32)
    v = rng.integers(0, 1 << 40, 200_000)
    app = con.appender("big")
    app.append_columns({"k": k, "v": v})
    app.close()
    con.query("CREATE INDEX bk ON big(k)")
    con.query("CREATE TABLE probe(k INTEGER)")
    pk = rng.integers(0, 400_000, 500).astype(np.int32)
    app = con.appender("probe")
    app.append_column("k", pk)
    app.close()
    r = con.query(
        "SELECT count(*), sum(b.v) FROM probe p JOIN big b ON p.k = b.k"
    ).fetchone()
    assert db.dist_stats.get("index_join", 0) > 0, "index join did not run"
    lut = {int(kk): int(vv) for kk, vv in zip(k, v)}
    exp_rows = [lut[int(x)] for x in pk if int(x) in lut]
    assert int(r[0]) == len(exp_rows)
    assert int(r[1]) == sum(exp_rows)
    db.close()
