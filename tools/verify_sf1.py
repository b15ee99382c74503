#!/usr/bin/env python
"""Verify all 22 TPC-H queries at SF1 against the sqlite3 oracle and write
TPCH_SF1_VERIFY.json (VERDICT r03 item 4: timing without result
verification is not parity; the reference verifies every benchmark run
against answer CSVs, benchmark/tpch/sf1/tpch_sf1.benchmark.in:17)."""
import json
import math
import sqlite3
import sys
import time

import numpy as np

import adacom as at
from adacom.bench import tpch


def _norm(rows):
    out = []
    for r in rows:
        nr = []
        for v in r:
            if v is None:
                nr.append(None)
            elif isinstance(v, (float, np.floating)):
                nr.append(float(v))
            elif isinstance(v, (int, np.integer)):
                nr.append(int(v))
            else:
                nr.append(str(v))
        out.append(tuple(nr))
    return out


def _rows_equal(got, exp):
    if len(got) != len(exp):
        return False
    for g, e in zip(got, exp):
        if len(g) != len(e):
            return False
        for a, b in zip(g, e):
            if isinstance(a, float) or isinstance(b, float):
                if a is None or b is None:
                    return False
                if not math.isclose(float(a), float(b), rel_tol=1e-9,
                                    abs_tol=1e-6):
                    return False
            elif a != b:
                return False
    return True


def main():
    sf = float(sys.argv[1]) if len(sys.argv) > 1 else 1.0
    t0 = time.time()
    data = tpch.generate(sf=sf)
    db = at.Database()
    con = db.connect()
    tpch.load_into_engine(con, data)
    db.catalog.get_column_segment_catalog().compact_all_segments()
    print(f"engine loaded +{time.time()-t0:.0f}s", file=sys.stderr, flush=True)
    lite = sqlite3.connect(":memory:")
    tpch.load_into_sqlite(lite, data)
    lite.execute("CREATE INDEX l_ok ON lineitem(l_orderkey)")
    lite.execute("CREATE INDEX l_pk ON lineitem(l_partkey)")
    lite.execute("CREATE INDEX l_sk ON lineitem(l_suppkey)")
    lite.execute("CREATE INDEX o_ok ON orders(o_orderkey)")
    lite.execute("CREATE INDEX ps_pk ON partsupp(ps_partkey)")
    print(f"oracle loaded +{time.time()-t0:.0f}s", file=sys.stderr, flush=True)
    results = {}
    for qid in sorted(tpch.QUERIES):
        sql = tpch.QUERIES[qid]
        te = time.perf_counter()
        got = _norm(con.query(sql).fetchall())
        te = time.perf_counter() - te
        ts = time.perf_counter()
        exp = _norm(lite.execute(tpch.oracle_sql(qid)).fetchall())
        ts = time.perf_counter() - ts
        if "ORDER BY" not in sql:
            got, exp = sorted(got, key=repr), sorted(exp, key=repr)
        ok = _rows_equal(got, exp)
        results[f"Q{qid:02d}"] = {
            "ok": bool(ok), "rows": len(got), "engine_s": round(te, 3),
            "oracle_s": round(ts, 3),
        }
        if not ok:
            results[f"Q{qid:02d}"]["got_head"] = [list(r) for r in got[:3]]
            results[f"Q{qid:02d}"]["exp_head"] = [list(r) for r in exp[:3]]
        print(f"Q{qid:02d} {'OK ' if ok else 'FAIL'} rows={len(got)} "
              f"engine={te:.2f}s oracle={ts:.2f}s", file=sys.stderr, flush=True)
    n_ok = sum(1 for r in results.values() if r["ok"])
    out = {"sf": sf, "passed": n_ok, "total": len(results),
           "queries": results}
    with open("TPCH_SF1_VERIFY.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"passed": n_ok, "total": len(results)}))
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
