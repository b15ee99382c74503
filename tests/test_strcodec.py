"""FSST-class dictionary compression (reference fsst.cpp +
third_party/fsst): native roundtrip, dictionary transparency, and the
codec's adopt-only-when-smaller gate."""

import numpy as np
import pytest

import adacom as at
from adacom import native
from adacom.storage.table import StringDictionary

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable")


def _corpus(strings):
    enc = [s.encode() for s in strings]
    corpus = b"".join(enc)
    offs = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(e) for e in enc], out=offs[1:])
    return np.frombuffer(corpus, np.uint8), offs, enc


def test_fsst_roundtrip_urls(rng):
    strings = [f"http://site{i % 971}.example.com/path/{i}?ref=abc"
               for i in rng.integers(0, 100000, 5000)]
    arr, offs, enc = _corpus(strings)
    symtab, symlens, n = native.fsst_train(arr)
    blob, eoffs = native.fsst_encode(symtab, symlens, n, arr, offs)
    assert len(blob) < 0.6 * len(arr)  # repetitive text compresses well
    for i in range(0, len(strings), 137):
        got = native.fsst_decode(symtab, symlens, n,
                                 blob[eoffs[i]:eoffs[i + 1]])
        assert got == enc[i]


def test_fsst_roundtrip_adversarial(rng):
    strings = ["", "a", "\x00\xff" * 3, "日本語テキスト", "x" * 500]
    strings += ["".join(chr(c) for c in rng.integers(32, 1000, rng.integers(0, 30)))
                for _ in range(500)]
    enc = [s.encode("utf-8") for s in strings]
    corpus = b"".join(enc)
    offs = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(e) for e in enc], out=offs[1:])
    arr = np.frombuffer(corpus, np.uint8)
    symtab, symlens, n = native.fsst_train(arr)
    out = native.fsst_encode(symtab, symlens, n, arr, offs)
    assert out is not None
    blob, eoffs = out
    for i in range(len(strings)):
        got = native.fsst_decode(symtab, symlens, n,
                                 blob[eoffs[i]:eoffs[i + 1]])
        assert got == enc[i], i


def test_dictionary_compress_transparent(rng):
    d = StringDictionary()
    strings = [f"customer-{i:06d}@mail-provider-{i % 37}.com"
               for i in range(20000)]
    codes = d.encode(strings)
    plain = d.footprint_bytes()
    assert d.compress_fsst()
    assert d.is_compressed()
    packed = d.footprint_bytes()
    assert packed < 0.7 * plain, (packed, plain)
    # random access decode without restoring the plain form
    sel = rng.integers(0, len(strings), 64)
    assert d.decode(codes[sel]) == [strings[i] for i in sel]
    assert d.is_compressed()
    # append path restores plain first (Uncompact-then-Append)
    c = d.encode_one("a-new-string")
    assert not d.is_compressed()
    assert d.decode(np.asarray([c])) == ["a-new-string"]
    assert d.decode(codes[sel]) == [strings[i] for i in sel]


def test_dictionary_incompressible_stays_plain(rng):
    d = StringDictionary()
    strings = ["".join(chr(c) for c in rng.integers(0x30, 0x2500, 24))
               for _ in range(2000)]
    d.encode(strings)
    # high-entropy strings: encoder output >= input -> keep plain
    assert not d.compress_fsst() or d.footprint_bytes() <= \
        sum(len(s.encode()) for s in strings) + 8 * (len(strings) + 1)


def test_engine_fsst_on_compact(rng):
    cfg = at.DBConfig()
    cfg.segment_rows = 4096
    db = at.Database(config=cfg)
    con = db.connect()
    con.query("CREATE TABLE t(v VARCHAR, i INTEGER)")
    strs = [f"/product/category-{i % 53}/item-{i:07d}" for i in range(30000)]
    app = con.appender("t")
    app.append_columns({"v": np.asarray(strs, dtype=object),
                        "i": np.arange(30000, dtype=np.int32)})
    app.close()
    col = db.catalog.get_table("t").columns["v"]
    plain = col.dictionary.footprint_bytes()
    db.catalog.get_column_segment_catalog().compact_all_segments()
    assert col.dictionary.is_compressed()
    assert col.dictionary.footprint_bytes() < plain
    # queries over the compressed dictionary still work
    r = con.query("SELECT count(*) FROM t WHERE v = '/product/category-1/item-0000001'").fetchone()
    assert int(r[0]) == 1
    r = con.query("SELECT v FROM t WHERE i = 12345").fetchone()
    assert r[0] == strs[12345]
    db.close()


def test_fsst_dictionary_checkpoint_roundtrip(tmp_path):
    """CHECKPOINT with an FSST-compressed dictionary persists the plain
    strings (codec-independent checkpoint format) and reloads exactly."""
    import os

    import numpy as np

    db = at.Database(path=str(tmp_path / "db"))
    con = db.connect()
    con.query("CREATE TABLE t(v VARCHAR)")
    strs = [f"/x/y/entry-{i:07d}" for i in range(20000)]
    app = con.appender("t")
    app.append_column("v", np.asarray(strs, dtype=object))
    app.close()
    db.catalog.get_column_segment_catalog().compact_all_segments()
    assert db.catalog.get_table("t").columns["v"].dictionary.is_compressed()
    con.query("CHECKPOINT")
    db.close()
    db2 = at.Database(path=str(tmp_path / "db"))
    con2 = db2.connect()
    r = con2.query("SELECT v FROM t WHERE v = '/x/y/entry-0012345'").fetchall()
    assert r == [("/x/y/entry-0012345",)]
    assert con2.query("SELECT count(*) FROM t").fetchone()[0] == 20000
    db2.close()
