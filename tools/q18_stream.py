#!/usr/bin/env python
"""Record the streamed join+aggregate pipeline's effect on TPC-H Q18/Q21
(VERDICT r4 #8): wall time variance and peak RSS with the aggregate sink
fused into the probe loop vs the materializing path. Host lane. Writes
STREAM_AGG_Q18.md."""
import resource
import subprocess
import sys

CHILD = """
import json, resource, sys, time
import jax
jax.config.update("jax_platforms", "cpu")
import adacom as at
from adacom.bench import tpch

stream = sys.argv[1] == "on"
data = tpch.generate(sf=1.0)
db = at.Database()
db.config.streaming_agg_sink_enabled = stream
con = db.connect()
tpch.load_into_engine(con, data)
db.catalog.get_column_segment_catalog().compact_all_segments()
del data
base_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
out = {}
for qid in (18, 21):
    con.query(tpch.QUERIES[qid])  # cold
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        con.query(tpch.QUERIES[qid])
        ts.append(time.perf_counter() - t0)
    out[qid] = ts
out["rss_mb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
out["base_rss_mb"] = base_rss / 1024
out["streamed"] = db.dist_stats.get("streamed_join_agg", 0)
print("RESULT " + json.dumps(out))
"""


def run(mode):
    r = subprocess.run([sys.executable, "-c", CHILD, mode],
                       capture_output=True, text=True, cwd=".")
    for line in r.stdout.splitlines():
        if line.startswith("RESULT "):
            import json
            return json.loads(line[7:])
    print(r.stdout[-2000:], r.stderr[-2000:], file=sys.stderr)
    raise SystemExit("child failed")


def main():
    import numpy as np
    on = run("on")
    off = run("off")
    lines = ["# Streamed join->aggregate sink: TPC-H Q18/Q21 (SF1, host lane)",
             "",
             "5 hot runs each, fresh process per mode; peak RSS from",
             "getrusage after the timed runs (load RSS shown for scale).",
             "", "| metric | agg sink fused (ON) | streamed join, materializing agg (OFF) |", "|---|---|---|"]
    for qid in ("18", "21"):
        a, b_ = on[qid], off[qid]
        lines.append(f"| Q{qid} mean (s) | {np.mean(a):.3f} | {np.mean(b_):.3f} |")
        lines.append(f"| Q{qid} min..max | {min(a):.3f}..{max(a):.3f} "
                     f"| {min(b_):.3f}..{max(b_):.3f} |")
    lines.append(f"| peak RSS (MB) | {on['rss_mb']:.0f} | {off['rss_mb']:.0f} |")
    lines.append(f"| RSS after load (MB) | {on['base_rss_mb']:.0f} "
                 f"| {off['base_rss_mb']:.0f} |")
    lines.append(f"| streamed_join_agg hits | {on['streamed']} | {off['streamed']} |")
    with open("STREAM_AGG_Q18.md", "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))


if __name__ == "__main__":
    main()
