"""Task-scheduler + inter-query concurrency tests.

Parity with the reference's parallelism test strategy (SURVEY.md §4):
test/sql/parallelism/intraquery (morsel parallel scans) and interquery
(concurrent connections)."""

import threading

import numpy as np

import adacom as at
from adacom.parallel.scheduler import TaskScheduler


def _db(n=200_000, segment_rows=8192):
    cfg = at.DBConfig()
    cfg.segment_rows = segment_rows
    db = at.Database(config=cfg)
    con = db.connect()
    con.query("CREATE TABLE t(i BIGINT, g INTEGER)")
    app = con.appender("t")
    v = np.arange(n, dtype=np.int64)
    app.append_columns({"i": v, "g": (v % 17).astype(np.int32)})
    app.close()
    return db, con, n


def test_parallel_host_scan_matches_serial():
    db, con, n = _db()
    sql = "SELECT SUM(i) FROM (SELECT i FROM t WHERE i % 3 = 1) q"
    con.query("SET threads = 1")
    serial = con.query(sql).scalar()
    con.query("SET threads = 8")
    parallel = con.query(sql).scalar()
    assert serial == parallel == int(np.arange(n)[np.arange(n) % 3 == 1].sum())
    db.close()


def test_scheduler_order_preserved():
    sched = TaskScheduler.get()
    items = list(range(100))
    out = sched.map_segments(lambda x: x * x, items, threads=8)
    assert out == [x * x for x in items]


def test_scheduler_exception_propagates():
    sched = TaskScheduler.get()

    def boom(x):
        if x == 37:
            raise ValueError("morsel 37")
        return x

    import pytest

    with pytest.raises(ValueError, match="morsel 37"):
        sched.map_segments(boom, list(range(64)), threads=8)


def test_interquery_concurrency():
    db, con, n = _db(n=100_000)
    errors = []
    results = {}

    def worker(k):
        c = db.connect()
        try:
            for _ in range(5):
                got = c.query(
                    f"SELECT COUNT(*), SUM(i) FROM t WHERE g = {k}").fetchall()
                results[k] = got
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    v = np.arange(n)
    for k, got in results.items():
        m = v % 17 == k
        assert got == [(int(m.sum()), int(v[m].sum()))]
    db.close()


def test_concurrent_read_while_compacting():
    db, con, n = _db(n=150_000)
    cat = db.catalog.get_column_segment_catalog()
    stop = threading.Event()
    errors = []

    def compact_loop():
        while not stop.is_set():
            cat.compact_all_segments()
            for t in db.catalog.tables.values():
                t.uncompact_all()

    bg = threading.Thread(target=compact_loop)
    bg.start()
    try:
        for _ in range(10):
            got = con.query("SELECT COUNT(*) FROM t WHERE i < 1000").scalar()
            assert got == 1000
    finally:
        stop.set()
        bg.join()
    db.close()
