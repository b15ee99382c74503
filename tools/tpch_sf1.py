#!/usr/bin/env python
"""Run the 22 TPC-H queries at SF1 on JAX's default device and write
TPCH_SF1.tsv (benchmark-runner TSV schema: name, run, timing, sizeInBytes,
MemoryAllocation) plus TPCH_SF1_COMPARE.md with the reference-runtime
comparison (the reference's TPCH_runtime.txt). One shared load, nruns hot
runs per query after a discarded cold run (benchmark_runner.cpp:120-131).
Both files name the device the run used.

Usage: python tools/tpch_sf1.py [nruns]"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

import adacom as at  # noqa: E402
from adacom.bench import tpch  # noqa: E402

REF = {1: 0.094, 2: 0.038, 3: 0.045, 4: 0.066, 5: 0.062, 6: 0.017,
       7: 0.073, 8: 0.059, 9: 0.113, 10: 0.072, 11: 0.027, 12: 0.055,
       13: 0.099, 14: 0.033, 15: 0.046, 16: 0.042, 17: 0.077, 18: 0.463,
       19: 0.060, 20: 0.057, 21: 0.217, 22: 0.031}


def main():
    nruns = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    data = tpch.generate(sf=1.0)
    dev = jax.devices()[0]
    device = f"{dev.platform} ({dev.device_kind}) x{len(jax.devices())}"
    db = at.Database()
    con = db.connect()
    tpch.load_into_engine(con, data)
    db.catalog.get_column_segment_catalog().compact_all_segments()
    cat = db.catalog.get_column_segment_catalog()
    size = cat.get_total_data_size()
    rows_tsv = []
    means = {}
    for qid in sorted(tpch.QUERIES):
        con.query(tpch.QUERIES[qid])  # discarded cold run
        ts = []
        for run in range(1, nruns + 1):
            t0 = time.perf_counter()
            con.query(tpch.QUERIES[qid])
            dt = time.perf_counter() - t0
            ts.append(dt)
            rows_tsv.append(f"TPCH_Q{qid:02d}\t{run}\t{dt:.6f}\t{size}\t"
                            f"{cat.get_total_data_size()}")
        means[qid] = ts
        print(f"Q{qid:02d} mean {np.mean(ts):.3f}s "
              f"(+/- {np.std(ts):.3f})", file=sys.stderr, flush=True)
    with open("TPCH_SF1.tsv", "w") as f:
        f.write(f"# device: {device}\n" + "\n".join(rows_tsv) + "\n")
    lines = [
        "# TPC-H SF1: adacom vs the reference's committed runtimes",
        "",
        "Reference numbers: the reference's TPCH_runtime.txt (means of 5",
        "runs, threads = hardware concurrency on an unspecified server).",
        f"This run: synthetic SF1 corpus (bench/tpch.py) on {device},",
        f"mean of {nruns} hot runs after a discarded cold run.",
        "tools/verify_sf1.py checks the 22 results against sqlite3.",
        "",
        "| Query | adacom (s) | min..max | reference (s) | ratio |",
        "|---|---|---|---|---|",
    ]
    tot = rtot = 0.0
    for qid in sorted(means):
        m = float(np.mean(means[qid]))
        lo, hi = min(means[qid]), max(means[qid])
        r = REF[qid]
        tot += m
        rtot += r
        lines.append(f"| Q{qid:02d} | {m:.3f} | {lo:.3f}..{hi:.3f} "
                     f"| {r:.3f} | {m / r:.1f}x |")
    lines.append(f"| **total** | **{tot:.2f}** |  | **{rtot:.2f}** | "
                 f"**{tot / rtot:.1f}x** |")
    with open("TPCH_SF1_COMPARE.md", "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"total {tot:.2f}s vs reference {rtot:.2f}s")


if __name__ == "__main__":
    sys.exit(main())
