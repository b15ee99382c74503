"""Out-of-core join/sort: results must match the in-RAM operators when a
memory limit forces partitioned spilling (reference ProbeSpill +
merge_sorter capability, VERDICT round 2 #8)."""

import numpy as np

import adacom as at
from adacom.exec import spill


def test_partitioned_join_pairs_matches_inram(rng):
    lk = rng.integers(0, 2000, 50_000).astype(np.uint64)
    rk = rng.integers(0, 2000, 8_000).astype(np.uint64)
    li, ri = spill.partitioned_join_pairs(lk, rk, 8)
    assert np.all(np.asarray(lk[np.asarray(li)]) == np.asarray(rk[np.asarray(ri)]))
    # pair-set equality vs the direct computation
    order = np.argsort(rk, kind="stable")
    rks = rk[order]
    lo = np.searchsorted(rks, lk, "left")
    hi = np.searchsorted(rks, lk, "right")
    assert len(li) == int((hi - lo).sum())


def test_external_sort_matches_lexsort(rng):
    a = rng.integers(-5000, 5000, 300_000).astype(np.int64)
    b = rng.integers(0, 10, 300_000).astype(np.int64)
    idx = spill.external_sort_indices([b, a], 8)  # a primary
    got_a = a[np.asarray(idx)]
    assert np.all(np.diff(got_a) >= 0)
    exp = np.lexsort((b, a))
    np.testing.assert_array_equal(a[exp], got_a)
    np.testing.assert_array_equal(b[exp], b[np.asarray(idx)])


def _mk(limit):
    cfg = at.DBConfig()
    cfg.segment_rows = 4096
    cfg.memory_limit = limit
    db = at.Database(config=cfg)
    return db, db.connect()


def test_sql_join_spills_and_matches(rng):
    n = 60_000
    k = rng.integers(0, 3000, n).astype(np.int32)
    v = np.arange(n, dtype=np.int32)
    sk = np.arange(3000, dtype=np.int32)
    sw = sk * 5

    def run(limit):
        db, con = _mk(limit)
        con.query("CREATE TABLE big(k INTEGER, v INTEGER)")
        con.query("CREATE TABLE small(k INTEGER, w INTEGER)")
        app = con.appender("big")
        app.append_columns({"k": k, "v": v})
        app.close()
        app = con.appender("small")
        app.append_columns({"k": sk, "w": sw})
        app.close()
        r = con.query(
            "SELECT count(*), sum(s.w), sum(b.v) FROM big b "
            "JOIN small s ON b.k = s.k").fetchone()
        db.close()
        return tuple(int(x) for x in r)

    # tiny limit forces the grace-hash spill; None runs fully in RAM
    assert run(1 << 20) == run(None)


def test_sql_order_by_spills_and_matches(rng):
    n = 400_000
    x = rng.integers(0, 1 << 30, n).astype(np.int32)

    def run(limit):
        db, con = _mk(limit)
        con.query("CREATE TABLE t(x INTEGER)")
        app = con.appender("t")
        app.append_column("x", x)
        app.close()
        r = con.query("SELECT x FROM t ORDER BY x").column(0)
        db.close()
        return np.asarray(r)

    np.testing.assert_array_equal(run(1 << 20), run(None))
