"""Segment / column / table storage tests: compact round-trips, zonemaps,
nulls, 64-bit planes, paging, adaptive policy."""

import numpy as np

from adacom import types as tt
from adacom.config import DBConfig
from adacom.catalog.segment_catalog import ColumnSegmentCatalog
from adacom.storage.buffer import BufferManager
from adacom.storage.segment import ColumnSegment
from adacom.storage.table import Table


def _mk(config=None):
    config = config or DBConfig(segment_rows=4096)
    bm = BufferManager(config)
    cat = ColumnSegmentCatalog(config)
    return config, bm, cat


def test_segment_compact_roundtrip(rng):
    config, bm, _ = _mk()
    vals = rng.integers(1_000_000, 1_065_536, size=4096, dtype=np.uint32)
    seg = ColumnSegment(tt.UINTEGER, vals, config, bm)
    np.testing.assert_array_equal(np.asarray(seg.decoded()), vals)
    assert seg.compact()
    assert seg.is_compacted()
    # width 17 -> ~17/32 of plain footprint
    assert seg.footprint_bytes() < 4096 * 4 * 0.6
    np.testing.assert_array_equal(np.asarray(seg.decoded()), vals)
    assert seg.uncompact()
    np.testing.assert_array_equal(np.asarray(seg.decoded()), vals)


def test_segment_constant(rng):
    config, bm, _ = _mk()
    vals = np.full(4096, 7_777_777, dtype=np.uint32)
    seg = ColumnSegment(tt.UINTEGER, vals, config, bm)
    seg.compact()
    assert seg.footprint_bytes() == 0  # constant plane stores nothing
    np.testing.assert_array_equal(np.asarray(seg.decoded()), vals)


def test_segment_int64_two_planes(rng):
    config, bm, _ = _mk()
    base = 10_000_000_000
    vals = (rng.integers(0, 1 << 40, size=4096, dtype=np.int64) + base).astype(np.int64)
    seg = ColumnSegment(tt.BIGINT, vals, config, bm)
    seg.compact()
    np.testing.assert_array_equal(np.asarray(seg.decoded()), vals)
    # 40-bit span -> ~(32+8)/64 of plain
    assert seg.footprint_bytes() < 4096 * 8 * 0.75


def test_segment_signed_negative(rng):
    config, bm, _ = _mk()
    vals = rng.integers(-500, 12_000, size=4096).astype(np.int32)
    seg = ColumnSegment(tt.INTEGER, vals, config, bm)
    seg.compact()
    np.testing.assert_array_equal(np.asarray(seg.decoded()), vals)
    assert seg.vmin == int(vals.min()) and seg.vmax == int(vals.max())


def test_segment_fetch_rows(rng):
    config, bm, _ = _mk()
    vals = rng.integers(0, 1 << 20, size=4096, dtype=np.uint32)
    seg = ColumnSegment(tt.UINTEGER, vals, config, bm)
    seg.compact()
    idx = rng.integers(0, 4096, size=100)
    np.testing.assert_array_equal(seg.fetch_rows(idx), vals[idx])


def test_segment_nulls(rng):
    config, bm, _ = _mk()
    vals = rng.integers(0, 1000, size=4096, dtype=np.uint32)
    validity = rng.random(4096) > 0.1
    seg = ColumnSegment(tt.UINTEGER, vals, config, bm, validity=validity)
    assert seg.null_count == int((~validity).sum())
    vr = seg.validity_reader()
    assert vr is not None
    meta, arrays, decode = vr
    bits = np.asarray(decode(*arrays))[:4096]
    np.testing.assert_array_equal(bits.astype(bool), validity)


def test_table_staging_and_segment_alignment(rng):
    config, bm, cat = _mk()
    t = Table("t", [("a", tt.UINTEGER), ("b", tt.BIGINT)], config, bm, cat)
    for _ in range(5):
        n = 3000
        t.append_batch({"a": rng.integers(0, 100, n).astype(np.uint32),
                        "b": rng.integers(0, 100, n).astype(np.int64)})
    assert t.row_count() == 15000
    t.flush()
    assert t.segment_count() == 4  # ceil(15000/4096)
    assert t.segment("a", 3).count == 15000 - 3 * 4096


def test_table_unseal_partial_append(rng):
    config, bm, cat = _mk()
    t = Table("t", [("a", tt.UINTEGER)], config, bm, cat)
    t.append_batch({"a": np.arange(100, dtype=np.uint32)})
    t.flush()
    assert t.segment_count() == 1
    t.append_batch({"a": np.arange(100, 200, dtype=np.uint32)})
    t.flush()
    # appended into the same partial segment, not a new one
    assert t.segment_count() == 1
    np.testing.assert_array_equal(
        np.asarray(t.segment("a", 0).decoded()), np.arange(200, dtype=np.uint32)
    )


def test_adaptive_policy_step(rng):
    config, bm, cat = _mk()
    t = Table("t", [("a", tt.UINTEGER)], config, bm, cat)
    t.append_batch({"a": rng.integers(0, 1 << 20, 4096 * 10).astype(np.uint32)})
    t.flush()
    segs = t.columns["a"].segments
    assert len(segs) == 10
    # hot: last segment read many times
    for _ in range(50):
        segs[-1].add_read_access()
    n_c, n_u = cat.compress_lowest_k_segments(rate=0.9)
    assert n_c == 9
    assert not segs[-1].is_compacted()
    assert all(s.is_compacted() for s in segs[:-1])
    # counters decayed, not reset
    assert segs[-1].num_reads == 25


def test_memory_limit_paging(rng):
    config = DBConfig(segment_rows=4096)
    config.memory_limit = 4096 * 4 * 3  # room for ~3 plain segments
    bm = BufferManager(config)
    cat = ColumnSegmentCatalog(config)
    t = Table("t", [("a", tt.UINTEGER)], config, bm, cat)
    t.append_batch({"a": rng.integers(0, 1 << 20, 4096 * 8).astype(np.uint32)})
    t.flush()
    segs = t.columns["a"].segments
    # scan everything twice; paging keeps device bytes under the limit
    for _ in range(2):
        for s in segs:
            _ = s.decoded()
    assert bm.device_bytes <= config.memory_limit
    for s in segs:
        np.testing.assert_array_equal(
            np.asarray(s.decoded()),
            s._host_values,
        )


def test_data_size_accounting(rng):
    config, bm, cat = _mk()
    t = Table("t", [("a", tt.UINTEGER)], config, bm, cat)
    t.append_batch({"a": rng.integers(0, 1 << 17, 4096 * 4).astype(np.uint32)})
    t.flush()
    plain_size = bm.get_data_size()
    assert plain_size == 4096 * 4 * 4
    t.compact_all()
    packed_size = bm.get_data_size()
    assert packed_size < plain_size
    assert packed_size == cat.get_total_data_size()
    t.uncompact_all()
    assert bm.get_data_size() == plain_size


def test_zonemap_fresh_after_tail_reseal():
    """Appending into a partial tail segment re-seals it with new bounds;
    filtered scans must see the fresh rows (stale-zonemap wrong-results
    bug found by tools/fuzz_dml.py seed 1)."""
    import numpy as np

    import adacom as at

    db = at.Database(config=at.DBConfig(segment_rows=1024))
    con = db.connect()
    con.query("CREATE TABLE t(a INTEGER)")
    con.query("INSERT INTO t VALUES (100), (101)")
    # a filtered scan caches the zonemaps for the 2-row tail segment
    assert con.query("SELECT count(*) FROM t WHERE a >= 500").scalar() == 0
    # append into the SAME tail segment with values outside its old bounds
    con.query("INSERT INTO t VALUES (900), (901)")
    assert con.query("SELECT count(*) FROM t WHERE a >= 500").scalar() == 2
    con.query("DELETE FROM t WHERE a >= 500")
    assert con.query("SELECT count(*) FROM t").scalar() == 2
    db.close()


def test_dml_fuzz_smoke():
    """Short randomized DML differential run vs sqlite (the longer sweeps
    live in tools/fuzz_dml.py)."""
    import os
    import subprocess
    import sys

    r = subprocess.run(
        [sys.executable, "tools/fuzz_dml.py", "80", "1"],
        capture_output=True, text=True, timeout=900,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": "."},
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]


def test_table_snapshot_survives_tail_unseal():
    """Deterministic core of the round-4 race: a pinned TableSnapshot
    stays fully resolvable while the writer pops/reseals the partial tail
    segment (unseal_last_partial) — the live list shrinks, the snapshot
    tuple does not."""
    import adacom as at

    cfg = at.DBConfig()
    cfg.segment_rows = 256
    db = at.Database(config=cfg)
    try:
        con = db.connect()
        con.query("CREATE TABLE t(i BIGINT)")
        app = con.appender("t")
        app.append_column("i", np.ones(300, np.int64))  # 1 full + partial
        app.close()
        table = db.catalog.get_table("t")
        snap = table.read_snapshot()
        n0 = snap.segment_count()
        rows0 = sum(snap.segment_rows(i) for i in range(n0))
        assert rows0 == 300
        # ten unseal/reseal cycles: each append pops the partial tail
        for _ in range(10):
            a = con.appender("t")
            a.append_column("i", np.ones(10, np.int64))
            a.close()
            table.flush()
        # live table moved on; the snapshot still resolves every segment
        assert snap.segment_count() == n0
        total = 0
        for i in range(n0):
            seg = snap.segment("i", i)
            total += int(seg.host_plain().sum())
        assert total == 300
        assert int(con.query("SELECT count(*) FROM t").scalar()) == 400
    finally:
        db.close()


def test_truncate_preserves_indexes_and_unique():
    """DELETE without WHERE must keep indexes live (round-4 repro: the
    drop-and-recreate truncate silently dropped UNIQUE enforcement)."""
    import adacom as at
    from adacom.storage.index import ConstraintViolation

    db = at.Database()
    try:
        con = db.connect()
        con.query("CREATE TABLE t(i BIGINT, s VARCHAR)")
        con.query("CREATE UNIQUE INDEX ui ON t(i)")
        con.query("INSERT INTO t VALUES (1, 'a'), (2, 'b')")
        con.query("DELETE FROM t")
        assert int(con.query("SELECT count(*) FROM t").scalar()) == 0
        # index object survived the truncate
        assert db.catalog.get_table("t").index_on("i") is not None
        con.query("INSERT INTO t VALUES (7, 'x')")
        import pytest as _pytest
        with _pytest.raises((ConstraintViolation, Exception)) as exc:
            con.query("INSERT INTO t VALUES (7, 'y')")
        assert "duplicate" in str(exc.value).lower() or \
            "unique" in str(exc.value).lower() or \
            "constraint" in str(exc.value).lower()
        # old keys were really dropped: re-inserting a pre-truncate key is fine
        con.query("INSERT INTO t VALUES (1, 'z')")
        assert int(con.query("SELECT count(*) FROM t").scalar()) == 2
    finally:
        db.close()
