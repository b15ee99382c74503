#!/usr/bin/env python
"""Run the 43-query ClickBench suite (reference SQL text) on JAX's default
device and write CLICKBENCH.tsv (benchmark-runner TSV schema, with a header
naming the device) + a summary line. One shared load; nruns hot runs per
query after a discarded cold run. --verify checks every query against the
sqlite3 oracle first.

Usage: python tools/clickbench_run.py [scale] [nruns] [--verify]"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

import adacom as at  # noqa: E402
from adacom.bench import clickbench as cb  # noqa: E402

VERIFY = "--verify" in sys.argv
sys.argv = [a for a in sys.argv if a != "--verify"]


def main():
    scale = float(sys.argv[1]) if len(sys.argv) > 1 else 0.1
    nruns = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    data = cb.generate(scale)
    dev = jax.devices()[0]
    device = f"{dev.platform} ({dev.device_kind}) x{len(jax.devices())}"
    db = at.Database()
    con = db.connect()
    cb.load_into_engine(con, data)
    lite = None
    if VERIFY:
        import sqlite3

        lite = sqlite3.connect(":memory:")
        cb.prepare_oracle(lite)
        cb.load_into_sqlite(lite, data)
    db.catalog.get_column_segment_catalog().compact_all_segments()
    cat = db.catalog.get_column_segment_catalog()
    size = cat.get_total_data_size()
    rows = len(data["hits"]["userid"][1])
    out = []
    tot = 0.0
    verified = 0
    for qid in sorted(cb.QUERIES):
        if lite is not None:
            ok = cb.verify_against_oracle(con, lite, qid)
            if not ok:
                raise AssertionError(f"Q{qid} mismatch vs sqlite oracle")
            verified += 1
        con.query(cb.QUERIES[qid])  # cold, discarded
        best = None
        for run in range(1, nruns + 1):
            t0 = time.perf_counter()
            con.query(cb.QUERIES[qid])
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
            out.append(f"ClickBench_Q{qid:02d}\t{run}\t{dt:.6f}\t{size}\t"
                       f"{cat.get_total_data_size()}")
        tot += best
        print(f"q{qid:02d} {best:.3f}s", file=sys.stderr, flush=True)
    with open("CLICKBENCH.tsv", "w") as f:
        lane = f"on {device}"
        ver = f", all {rows}-row results oracle-verified" if VERIFY else ""
        f.write(f"# ClickBench 43 queries, {rows} rows (scale {scale}), "
                f"{lane}{ver}\n")
        f.write("\n".join(out) + "\n")
    print(f"total (best-of-{nruns} sum) {tot:.2f}s over {rows} rows")


if __name__ == "__main__":
    sys.exit(main())
