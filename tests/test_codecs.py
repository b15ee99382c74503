"""Compression-framework tests (ops/codecs.py + segment integration).

The reference has per-codec sqllogictests under
test/sql/storage/compression/{bitpacking,rle,dictionary,...} plus
compression_selection.test / compression_force_selection.test; these tests
are this engine's equivalent, run over the generic codec registry."""

import numpy as np
import pytest

import adacom as at
from adacom import types as tt
from adacom.ops import bitpack, codecs


def _roundtrip(codec_name, values, ltype=tt.INTEGER):
    cfg = at.DBConfig()
    c = codecs.REGISTRY[codec_name]
    assert c.analyze(values, ltype, cfg) is not None, "codec not applicable"
    enc = c.encode(values, ltype, cfg)
    out = np.asarray(codecs.decode_full(enc, values.dtype))
    np.testing.assert_array_equal(out, values)
    # random access
    rng = np.random.default_rng(7)
    idx = rng.integers(0, len(values), size=min(64, len(values)))
    import jax.numpy as jnp

    got = np.asarray(codecs.gather(enc, jnp.asarray(idx)))
    np.testing.assert_array_equal(got, values[idx])
    return enc


DATASETS = {
    "constant": np.full(5000, 42, dtype=np.int32),
    "rle": np.repeat(np.arange(37, dtype=np.int32), 173),
    "delta": np.arange(10_000, dtype=np.int64) * 3 + 17,
    "dictionary": np.random.default_rng(3).choice(
        np.asarray([5, 900, 31, 77, 123456], dtype=np.int32), size=9000),
}


@pytest.mark.parametrize("codec", sorted(DATASETS))
def test_roundtrip(codec):
    enc = _roundtrip(codec, DATASETS[codec])
    plain = DATASETS[codec].nbytes
    assert enc.nbytes < plain, f"{codec}: {enc.nbytes} !< {plain}"


def test_delta_wraparound_domain():
    # deltas that wrap the unsigned domain stay exact (mod-2^w arithmetic)
    v = np.asarray([0, 2**31 - 1, -2**31, 5, -5], dtype=np.int32)
    v = np.tile(v, 100)
    cfg = at.DBConfig()
    c = codecs.REGISTRY["delta"]
    if c.analyze(v, tt.INTEGER, cfg) is None:
        pytest.skip("span too wide for delta")
    enc = c.encode(v, tt.INTEGER, cfg)
    np.testing.assert_array_equal(
        np.asarray(codecs.decode_full(enc, v.dtype)), v)


def test_rle_floats():
    v = np.repeat(np.asarray([1.5, -2.25, 0.0, 3.125], dtype=np.float64), 500)
    _roundtrip("rle", v, tt.DOUBLE)


def test_alp_exact_decimals():
    """ALP contract: the packed integer planes are exact, and the f64
    decode is bit-exact both on the device (IEEE float64 on CPU and GPU)
    and via the host materialization path (decode_full_host)."""
    rng = np.random.default_rng(11)
    v = (rng.integers(-10_000, 10_000, 8000) / 100.0).astype(np.float64)
    cfg = at.DBConfig()
    c = codecs.REGISTRY["alp"]
    assert c.analyze(v, tt.DOUBLE, cfg) is not None
    enc = c.encode(v, tt.DOUBLE, cfg)
    # host materialization: bit-exact on every backend
    np.testing.assert_array_equal(codecs.decode_full_host(enc, v.dtype), v)
    dev = np.asarray(codecs.decode_full(enc, v.dtype))
    np.testing.assert_array_equal(dev, v)
    rng2 = np.random.default_rng(7)
    idx = rng2.integers(0, len(v), size=64)
    import jax.numpy as jnp

    got = np.asarray(codecs.gather(enc, jnp.asarray(idx)))
    np.testing.assert_array_equal(got, v[idx])
    assert enc.nbytes < v.nbytes / 2


def test_alp_rejects_irrational():
    v = np.random.default_rng(5).standard_normal(4096)
    assert codecs.REGISTRY["alp"].analyze(v, tt.DOUBLE, at.DBConfig()) is None


def test_detect_best_codec():
    cfg = at.DBConfig()
    seq = np.arange(100_000, dtype=np.int64)
    name, est = codecs.detect_best_codec(seq, tt.BIGINT, cfg, succinct_bytes=
                                         17 * bitpack.lanes_for(len(seq)) * 4)
    assert name == "delta"  # sequential packs to ~2 bits/row
    runs = np.repeat(np.arange(10, dtype=np.int32), 10_000)
    name, _ = codecs.detect_best_codec(runs, tt.INTEGER, cfg, None)
    assert name == "rle"
    const = np.full(100_000, 7, dtype=np.int32)
    name, _ = codecs.detect_best_codec(const, tt.INTEGER, cfg, None)
    assert name == "constant"
    rnd = np.random.default_rng(1).integers(0, 2**31, 100_000).astype(np.int32)
    name, _ = codecs.detect_best_codec(rnd, tt.INTEGER, cfg, 100_000 * 4 - 1)
    assert name == "succinct"


# ----------------------------------------------------------------------
# SQL-level: force_compression / compression_codec / compression_info
# ----------------------------------------------------------------------


def _mk(rows, codec=None, auto=False):
    cfg = at.DBConfig()
    cfg.segment_rows = 4096
    if codec:
        cfg.force_compression = codec
    if auto:
        cfg.compression_codec = "auto"
    db = at.Database(config=cfg)
    con = db.connect()
    con.query("CREATE TABLE t(i BIGINT)")
    app = con.appender("t")
    app.append_column("i", rows)
    app.close()
    db.catalog.get_column_segment_catalog().compact_all_segments()
    return db, con


@pytest.mark.parametrize("codec", ["rle", "delta", "dictionary", "succinct"])
def test_forced_codec_query(codec):
    n = 20_000
    if codec == "rle":
        data = np.repeat(np.arange(50, dtype=np.int64), n // 50)
    elif codec == "dictionary":
        data = np.random.default_rng(2).choice(
            np.asarray([3, 1000, 7_000_000], dtype=np.int64), size=n)
    else:
        data = np.arange(n, dtype=np.int64)
    db, con = _mk(data, codec=codec)
    info = con.query("PRAGMA compression_info('t')").to_dicts()
    assert all(r["codec"] == codec for r in info), info[:3]
    got = con.query("SELECT COUNT(*) c, SUM(i) s FROM t").to_dicts()[0]
    assert got["c"] == n and got["s"] == int(data.sum())
    v = int(data[12_345])
    r = con.query(f"SELECT COUNT(*) c FROM t WHERE i = {v}").to_dicts()[0]
    assert r["c"] == int((data == v).sum())
    db.close()


def test_auto_selection_end_to_end():
    n = 30_000
    data = np.arange(n, dtype=np.int64)  # sequential -> delta should win
    db, con = _mk(data, auto=True)
    info = con.query("PRAGMA compression_info('t')").to_dicts()
    assert all(r["codec"] == "delta" for r in info), info[:3]
    got = con.query("SELECT SUM(i) s FROM t WHERE i % 2 = 0").to_dicts()[0]
    assert got["s"] == int(data[data % 2 == 0].sum())
    db.close()


def test_checkpoint_preserves_codec(tmp_path):
    data = np.repeat(np.arange(40, dtype=np.int64), 500)
    db, con = _mk(data, codec="rle")
    path = str(tmp_path / "ckpt")
    from adacom.storage.checkpoint import write_checkpoint

    write_checkpoint(db, path)
    db.close()

    db2 = at.Database(path=path)
    con2 = db2.connect()
    info = con2.query("PRAGMA compression_info('t')").to_dicts()
    assert all(r["codec"] == "rle" for r in info)
    got = con2.query("SELECT SUM(i) s FROM t").to_dicts()[0]
    assert got["s"] == int(data.sum())
    db2.close()
