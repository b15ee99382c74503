#!/usr/bin/env python
"""Adaptive-compaction evidence over time (the paper's core claim,
reference zipf_over_time.cpp + experiments/ plots): run a Zipf point-
lookup workload while the background policy recompresses cold segments,
and record per-interval QPS + data footprint + segment states. Writes
ADAPTIVE_OVERTIME.tsv.

Expected shape: footprint starts fully-compressed (CompactAllSegments at
load), the policy UNCOMPRESSES the hot head (faster lookups, more bytes)
and keeps the cold tail compressed — landing between the all-plain and
all-packed footprints with hot-tier latency."""
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")  # host latency tier exercises this

import numpy as np  # noqa: E402

import adacom as at  # noqa: E402
from adacom.bench.zipf import ZipfSampler  # noqa: E402


def main():
    n = int(float(sys.argv[1])) if len(sys.argv) > 1 else 20_000_000
    seconds = float(sys.argv[2]) if len(sys.argv) > 2 else 30.0
    cfg = at.DBConfig()
    cfg.adaptive_succinct_compression_enabled = True
    cfg.compaction_period_s = 2.0
    db = at.Database(config=cfg)
    con = db.connect()
    con.query("CREATE TABLE t1(i UINTEGER)")
    app = con.appender("t1")
    chunk = 8 << 20
    for start in range(0, n, chunk):
        app.append_column("i", np.arange(start, min(start + chunk, n),
                                         dtype=np.uint32))
    app.close()
    cat = db.catalog.get_column_segment_catalog()
    cat.compact_all_segments()
    packed_bytes = cat.get_total_data_size()
    plain_bytes = 4 * n
    vals = ZipfSampler(n, 1.0, seed=31).sample(1 << 22)
    rows = ["second\tqps\tdata_bytes\tn_packed\tn_plain\tpolicy_rounds"]
    t0 = time.perf_counter()
    t_int = t0
    done = 0
    k = 0
    sec = 0
    while time.perf_counter() - t0 < seconds:
        v = int(vals[k % len(vals)])
        k += 1
        con.query(f"SELECT i FROM t1 WHERE i == {v}")
        done += 1
        now = time.perf_counter()
        if now - t_int >= 1.0:
            segs = cat.segments_snapshot()
            n_packed = sum(1 for s in segs if s.is_compacted())
            sec += 1
            rows.append(f"{sec}\t{done / (now - t_int):.0f}\t"
                        f"{cat.get_total_data_size()}\t{n_packed}\t"
                        f"{len(segs) - n_packed}\t{cat.policy_rounds}")
            print(rows[-1], file=sys.stderr, flush=True)
            t_int = now
            done = 0
    cat.disable_background_compaction()
    rows.append(f"# all-plain={plain_bytes} all-packed={packed_bytes} "
                f"rows={n}")
    with open("ADAPTIVE_OVERTIME.tsv", "w") as f:
        f.write("\n".join(rows) + "\n")
    db.close()
    print("\n".join(rows[-3:]))


if __name__ == "__main__":
    sys.exit(main())
