"""WAL + replay + checkpoint durability tests.

Parity with the reference's WAL replay (wal_replay.cpp) and checkpoint-abort
fault injection (PRAGMA debug_checkpoint_abort,
test/sql/storage/checkpoint_abort*.test_slow)."""

import os

import numpy as np
import pytest

import adacom as at


def _open(path, **cfg_kw):
    cfg = at.DBConfig()
    cfg.segment_rows = 4096
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    db = at.Database(path=str(path), config=cfg)
    return db, db.connect()


def _crash(db):
    """Simulate a crash: drop the handle without checkpointing."""
    if db.wal is not None:
        db.wal.close()
    db.catalog.shutdown()
    db._closed = True


def test_replay_after_crash(tmp_path):
    db, con = _open(tmp_path / "d")
    con.query("CREATE TABLE t(i INTEGER, s VARCHAR)")
    con.query("INSERT INTO t VALUES (1, 'a'), (2, 'b'), (3, 'c')")
    con.query("CREATE VIEW v AS SELECT i FROM t WHERE i > 1")
    _crash(db)  # no checkpoint: only the WAL survives

    db2, con2 = _open(tmp_path / "d")
    assert con2.query("SELECT i, s FROM t ORDER BY i").fetchall() == [
        (1, "a"), (2, "b"), (3, "c")]
    assert con2.query("SELECT COUNT(*) FROM v").scalar() == 2
    db2.close()


def test_checkpoint_then_wal_tail(tmp_path):
    db, con = _open(tmp_path / "d")
    con.query("CREATE TABLE t(i BIGINT)")
    app = con.appender("t")
    app.append_column("i", np.arange(10_000, dtype=np.int64))
    app.close()
    con.query("CHECKPOINT")
    assert db.wal.size() == 0  # truncated
    con.query("INSERT INTO t VALUES (123456)")  # post-checkpoint tail
    _crash(db)

    db2, con2 = _open(tmp_path / "d")
    assert con2.query("SELECT COUNT(*) FROM t").scalar() == 10_001
    assert con2.query("SELECT MAX(i) FROM t").scalar() == 123456
    db2.close()


def test_delete_update_replay(tmp_path):
    db, con = _open(tmp_path / "d")
    con.query("CREATE TABLE t(i INTEGER)")
    con.query("INSERT INTO t VALUES (1), (2), (3), (4), (5)")
    con.query("DELETE FROM t WHERE i = 2")
    con.query("UPDATE t SET i = 40 WHERE i = 4")
    _crash(db)

    db2, con2 = _open(tmp_path / "d")
    got = sorted(r[0] for r in con2.query("SELECT i FROM t").fetchall())
    assert got == [1, 3, 5, 40]
    db2.close()


def test_rollback_not_durable(tmp_path):
    db, con = _open(tmp_path / "d")
    con.query("CREATE TABLE t(i INTEGER)")
    con.query("INSERT INTO t VALUES (1)")
    con.query("BEGIN")
    con.query("INSERT INTO t VALUES (2), (3)")
    con.query("ROLLBACK")
    con.query("BEGIN")
    con.query("INSERT INTO t VALUES (9)")
    con.query("COMMIT")
    _crash(db)

    db2, con2 = _open(tmp_path / "d")
    got = sorted(r[0] for r in con2.query("SELECT i FROM t").fetchall())
    assert got == [1, 9]
    db2.close()


def test_torn_tail_record(tmp_path):
    db, con = _open(tmp_path / "d")
    con.query("CREATE TABLE t(i INTEGER)")
    con.query("INSERT INTO t VALUES (10), (20)")
    _crash(db)
    # simulate a crash mid-append: garbage partial record at the tail
    with open(tmp_path / "d" / "wal.log", "ab") as f:
        f.write(b"\xff\xff\xff\xff\x00\x00\x00\x00partial")

    db2, con2 = _open(tmp_path / "d")
    assert con2.query("SELECT COUNT(*) FROM t").scalar() == 2
    db2.close()


def test_checkpoint_abort_recovers(tmp_path):
    from adacom.main.database import CheckpointAbort

    db, con = _open(tmp_path / "d")
    con.query("CREATE TABLE t(i INTEGER)")
    con.query("INSERT INTO t VALUES (7), (8)")
    con.query("CHECKPOINT")
    con.query("INSERT INTO t VALUES (9)")
    con.query("SET debug_checkpoint_abort = 'before_header'")
    with pytest.raises(CheckpointAbort):
        con.query("CHECKPOINT")
    _crash(db)

    # the aborted checkpoint must be invisible: old ckpt + WAL reconstruct
    db2, con2 = _open(tmp_path / "d")
    got = sorted(r[0] for r in con2.query("SELECT i FROM t").fetchall())
    assert got == [7, 8, 9]
    db2.close()


def test_autocheckpoint_threshold(tmp_path):
    db, con = _open(tmp_path / "d", wal_autocheckpoint=2_000)
    con.query("CREATE TABLE t(i BIGINT)")
    for k in range(6):
        con.query(f"INSERT INTO t VALUES ({k})")
    # the WAL must have been checkpoint-truncated at least once
    assert db.wal.size() < 2_000 + 600
    assert db._read_current() is not None
    _crash(db)
    db2, con2 = _open(tmp_path / "d")
    assert con2.query("SELECT COUNT(*) FROM t").scalar() == 6
    db2.close()


def test_checkpoint_restores_deletes(tmp_path):
    # regression: checkpoint stored delete *masks* where restore expected
    # row indices, corrupting deletes across reopen
    db, con = _open(tmp_path / "d")
    con.query("CREATE TABLE t(i INTEGER)")
    app = con.appender("t")
    app.append_column("i", np.arange(20_000, dtype=np.int32))
    app.close()
    con.query("DELETE FROM t WHERE i % 1000 = 7")
    db.close()  # checkpoints

    db2, con2 = _open(tmp_path / "d")
    assert con2.query("SELECT COUNT(*) FROM t").scalar() == 20_000 - 20
    assert con2.query("SELECT COUNT(*) FROM t WHERE i = 1007").scalar() == 0
    assert con2.query("SELECT COUNT(*) FROM t WHERE i = 1008").scalar() == 1
    db2.close()


def test_close_checkpoints_and_reopen(tmp_path):
    db, con = _open(tmp_path / "d")
    con.query("CREATE TABLE t(i INTEGER, x DOUBLE)")
    app = con.appender("t")
    app.append_columns({"i": np.arange(9_000, dtype=np.int32),
                        "x": np.round(np.arange(9_000) * 0.25, 2)})
    app.close()
    db.catalog.get_column_segment_catalog().compact_all_segments()
    db.close()
    assert os.path.exists(tmp_path / "d" / "CURRENT")

    db2, con2 = _open(tmp_path / "d")
    assert con2.query("SELECT COUNT(*) FROM t").scalar() == 9_000
    s = con2.query("SELECT SUM(x) FROM t").scalar()
    assert abs(s - np.round(np.arange(9_000) * 0.25, 2).sum()) < 1e-6
    db2.close()


def test_truncate_replay(tmp_path):
    """DELETE-without-WHERE logs a truncate record; replay reproduces the
    emptied-then-refilled state and the index survives in both worlds."""
    db, con = _open(tmp_path / "d")
    con.query("CREATE TABLE t(i BIGINT)")
    con.query("CREATE UNIQUE INDEX ui ON t(i)")
    con.query("INSERT INTO t VALUES (1), (2), (3)")
    con.query("DELETE FROM t")
    con.query("INSERT INTO t VALUES (9)")
    _crash(db)
    db2, con2 = _open(tmp_path / "d")
    assert [r[0] for r in con2.query("SELECT i FROM t").fetchall()] == [9]
    assert db2.catalog.get_table("t").index_on("i") is not None
    # UNIQUE still enforced post-replay
    with pytest.raises(Exception):
        con2.query("INSERT INTO t VALUES (9)")
    db2.close()
