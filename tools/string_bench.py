#!/usr/bin/env python
"""String-compression evidence (VERDICT r03 missing #6 / next #9): does
the dictionary-at-ingest story hold as VARCHAR cardinality rises, and
what does the FSST-class dictionary codec add?  Writes STRING_BENCH.json.

Sweep: 2M rows at distinct-string cardinalities 1k / 100k / 2M (unique).
Footprints: raw utf-8 + offsets, dictionary (u32 codes + plain dict),
dictionary + FSST blob.  Times: full-scan LIKE filter and point equality
on the engine at each tier."""
import json
import sys
import time

import numpy as np

import adacom as at


def one_case(n_rows: int, card: int):
    rng = np.random.default_rng(7)
    ids = rng.integers(0, card, n_rows)
    strs = np.asarray(
        [f"/warehouse/region-{i % 89:02d}/aisle-{(i // 89) % 97:02d}/sku-{i:09d}"
         for i in ids], dtype=object)
    raw_bytes = sum(len(s.encode()) for s in strs) + 8 * (n_rows + 1)

    cfg = at.DBConfig()
    cfg.segment_rows = 65536
    db = at.Database(config=cfg)
    con = db.connect()
    con.query("CREATE TABLE t(v VARCHAR)")
    app = con.appender("t")
    app.append_column("v", strs)
    app.close()
    col = db.catalog.get_table("t").columns["v"]
    codes_bytes = 4 * n_rows
    dict_plain = col.dictionary.footprint_bytes()

    probe = strs[n_rows // 2]
    like_sql = "SELECT count(*) FROM t WHERE contains(v, 'aisle-42')"
    eq_sql = f"SELECT count(*) FROM t WHERE v = '{probe}'"

    def best3(sql):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            con.query(sql)
            ts.append(time.perf_counter() - t0)
        return round(min(ts), 4)

    t_like_plain = best3(like_sql)
    t_eq_plain = best3(eq_sql)

    db.catalog.get_column_segment_catalog().compact_all_segments()
    fsst_on = col.dictionary.is_compressed()
    dict_fsst = col.dictionary.footprint_bytes()
    t_like_fsst = best3(like_sql)
    t_eq_fsst = best3(eq_sql)
    db.close()
    return {
        "rows": n_rows,
        "distinct": int(card),
        "raw_bytes": int(raw_bytes),
        "dict_bytes": int(codes_bytes + dict_plain),
        "dict_fsst_bytes": int(codes_bytes + dict_fsst),
        "fsst_adopted": bool(fsst_on),
        "vs_raw_dict": round((codes_bytes + dict_plain) / raw_bytes, 3),
        "vs_raw_dict_fsst": round((codes_bytes + dict_fsst) / raw_bytes, 3),
        "scan_contains_s": {"plain": t_like_plain, "fsst": t_like_fsst},
        "point_eq_s": {"plain": t_eq_plain, "fsst": t_eq_fsst},
    }


def main():
    n_rows = int(float(sys.argv[1])) if len(sys.argv) > 1 else 2_000_000
    out = [one_case(n_rows, c) for c in (1_000, 100_000, n_rows)]
    with open("STRING_BENCH.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    sys.exit(main())
